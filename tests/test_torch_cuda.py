"""CUDA kernels of the port on the card: each kernel against its plain
PyTorch version at the shapes the main paths give it, the wrappers'
refusals, and the two paths (the stereo slice; stereo + IMU + loop)
launching their kernels.

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
IMU_TOL = 1e-6                                    # small-angle series vs exact exp
FAST_TOL = 1e-3                                   # sum-order rounding, [0, 255] inputs


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
    from flvis_tpu_torch.config import BackendConfig, FrontendConfig, SystemConfig
    from flvis_tpu_torch.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory
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


def test_imu_chain_kernel_matches_plain(dev):
    from flvis_tpu_torch.geometry import so3
    from flvis_tpu_torch.ops.kernels import imu_chain

    rng = np.random.default_rng(5)
    P = 16
    f = dict(dtype=torch.float32, device=dev)
    q0 = so3.normalize(torch.as_tensor(rng.normal(0, 1, 4), **f))
    G = so3.exp(torch.as_tensor(rng.normal(0, 0.01, (P, 3)), **f)).contiguous()
    a = rng.normal(0, 1, (P, 3))
    a = torch.as_tensor(a / np.linalg.norm(a, axis=1, keepdims=True), **f)
    c = torch.as_tensor(rng.uniform(0, 0.025, P), **f)
    before = imu_chain.attitude_chain_kernel.launches
    got = imu_chain.attitude_chain(q0, G, a, c)
    ref = imu_chain.attitude_chain_plain(q0, G, a, c)
    torch.cuda.synchronize()
    assert imu_chain.attitude_chain_kernel.launches == before + 1
    assert float((got - ref).abs().max()) <= IMU_TOL


@pytest.mark.parametrize("shape", [(480, 752), (61, 87)])
def test_fastblur_kernel_matches_plain(dev, shape):
    from flvis_tpu_torch.ops.kernels import fastblur

    img = torch.as_tensor(np.random.default_rng(1).uniform(0, 255, shape),
                          dtype=torch.float32, device=dev)
    s_k, b_k = fastblur.fast_score_nms_blur(img, 20.0, 20)
    s_p, b_p = fastblur.fast_score_nms_blur_plain(img, 20.0, 20)
    torch.cuda.synchronize()
    assert torch.equal(s_k > 0, s_p > 0)
    assert float((s_k - s_p).abs().max()) <= FAST_TOL
    assert float((b_k - b_p).abs().max()) <= FAST_TOL


@pytest.mark.parametrize("shape", [(240, 376), (37, 50)])
def test_sweep_kernel_matches_plain(dev, shape):
    """Same costs in the same add order: the maps agree exactly."""
    from flvis_tpu_torch.io.synthetic import PlanarScene, SceneConfig
    from flvis_tpu_torch.ops.kernels import sweep

    h, w = shape
    scfg = SceneConfig(width=2 * w, height=2 * h, fx=458.0, fy=458.0, cx=w, cy=h,
                       baseline=0.11)
    l, r, _ = PlanarScene(scfg, plane_depth=2.0, seed=0).render(np.eye(3), np.zeros(3))

    def half(a):
        a = torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return a.reshape(h, 2, w, 2).mean(dim=(1, 3)).contiguous()

    L, R = half(l), half(r)
    got = sweep.sweep_maps(L, R)
    ref = sweep.sweep_maps_plain(L, R)
    torch.cuda.synchronize()
    assert torch.equal(got[2], ref[2]) and bool(got[2].any())
    assert float((got[0] - ref[0]).abs().max()) <= 1e-3
    assert torch.equal(got[1], ref[1])


@pytest.mark.parametrize("na,nb", [(1000, 1000), (17, 5)])
def test_hamming_kernel_exact(dev, na, nb):
    from flvis_tpu_torch.ops.kernels import hamming

    rng = np.random.default_rng(na)
    a = torch.as_tensor(rng.integers(0, 2 ** 32, (na, 8), dtype=np.uint32).view(np.int32),
                        device=dev)
    b = torch.as_tensor(rng.integers(0, 2 ** 32, (nb, 8), dtype=np.uint32).view(np.int32),
                        device=dev)
    got = hamming.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, hamming.hamming_matrix_plain(a, b))


def test_new_kernel_wrappers_refuse_bad_input(dev):
    from flvis_tpu_torch.ops.kernels import fastblur, hamming, imu_chain, sweep

    with pytest.raises(ValueError, match="float32"):
        fastblur.fast_score_nms_blur(torch.zeros((64, 64), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="margin"):
        fastblur.fast_score_nms_blur(torch.zeros((64, 64), device=dev), 20.0, 2)
    with pytest.raises(ValueError, match="two"):
        sweep.sweep_maps(torch.zeros((8, 32), device=dev), torch.zeros((8, 33), device=dev))
    with pytest.raises(ValueError, match="int32"):
        hamming.hamming_matrix(torch.zeros((4, 8), device=dev),
                               torch.zeros((4, 8), device=dev))
    with pytest.raises(ValueError, match=r"\(N, 8\)"):
        hamming.hamming_matrix(torch.zeros((4, 4), dtype=torch.int32, device=dev),
                               torch.zeros((4, 8), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="expected q0"):
        imu_chain.attitude_chain(torch.zeros(4, device=dev), torch.zeros((3, 4), device=dev),
                                 torch.zeros((2, 3), device=dev), torch.zeros(3, device=dev))


def test_vio_loop_path_launches_its_kernels(dev):
    """The stereo + IMU + loop path at the small config of
    tests/test_torch_runner.py: imu_chain on every IMU-initialised frame,
    fastblur and sweep on every keyframe, hamming on every verification."""
    from flvis_tpu_torch.config import BackendConfig, FrontendConfig, LoopConfig, SystemConfig
    from flvis_tpu_torch.geometry import camera
    from flvis_tpu_torch.io.synthetic import PlanarScene, SceneConfig, imu_from_trajectory
    from flvis_tpu_torch.ops.kernels import fastblur, hamming, imu_chain, sweep
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                       baseline=0.12)
    cfg = SystemConfig(
        frontend=FrontendConfig(width=256, height=192, num_slots=128, pyramid_levels=3,
                                per_cell=8, min_distance=12.0, margin=22, kf_min_trans=0.04),
        backend=BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4),
        loop=LoopConfig(max_keyframes=64, num_orb_features=128, vocab_words=128,
                        kf_start=10, kf_dist=8, kf_max_dist=64, nkf_closest=2, min_pts=12,
                        min_score=0.03, ratio_ransac=0.3, seq_edge_successors=3))
    cam = camera.make(200.0, 200.0, 128.0, 96.0, 0.12, width=256, height=192, device=dev)
    n = 24
    xs = list(np.linspace(0, 0.9, n // 2)) + list(np.linspace(0.9, 0.02, n - n // 2))
    poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
    frames = [scene.render(R, t)[:2] for (R, t) in poses]
    t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
    accs, gyros, imuts, prev = [], [], [], -np.inf
    for ft in frame_t:
        m = (t_imu > prev) & (t_imu <= ft)
        accs.append(acc[m]); gyros.append(gyro[m]); imuts.append(t_imu[m])
        prev = ft
    kernels = (imu_chain.attitude_chain_kernel, fastblur.fast_score_nms_blur_kernel,
               sweep.sweep_maps_kernel, hamming.hamming_matrix_kernel)
    before = [k.launches for k in kernels]
    slam = SlamSystem(cfg, cam, device=dev, use_imu=True, use_loop=True)
    out = slam.process_frames_vio(np.stack([f[0] for f in frames]),
                                  np.stack([f[1] for f in frames]), ts=frame_t,
                                  imu_acc=accs, imu_gyro=gyros, imu_t=imuts)
    d = [k.launches - b for k, b in zip(kernels, before)]
    n_kf = int(out.is_keyframe.sum())
    init_frames = int(np.sum(np.cumsum([len(t) for t in imuts])[:-1] >= cfg.vio.init_samples))
    assert (out.status[1:] == 1).all()
    assert d[0] >= init_frames > 0
    assert d[1] >= n_kf and d[2] >= n_kf and n_kf == slam.loop_closer.count
    assert len(slam.loop_closer.closures) >= 1 and d[3] >= len(slam.loop_closer.closures)
