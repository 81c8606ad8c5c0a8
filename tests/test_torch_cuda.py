"""CUDA kernels of the port on the card: each kernel against its plain
PyTorch version at the shapes the main paths give it, the wrappers'
refusals, the two paths (the stereo slice; stereo + IMU + loop)
launching their kernels, and the captured frame step (one CUDA graph a
frame) against the eager composition.

Needs an NVIDIA GPU; every test skips without one (marker `cuda`).  This
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import functools

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

GRAD_TOL = 1e-3                                   # nvcc FMA contraction, [0, 255] inputs
SCHUR_TOL = {"t": 2e-4, "q": 2e-5, "lm": 2e-3}    # tests/test_window_ba.py:201-207
IMU_TOL = 1e-6                                    # small-angle series vs exact exp
# The fused feed's pos and vel: the same left-to-right sums as the plain
# version, but float32 with nvcc's FMA contraction on one side and PyTorch's
# cumsum on the other; |pos|, |vel| stay below ~2 over these packets, so a
# few ulps (1.2e-7 relative) over up to 48 summed terms stay under 1e-5.
IMU_SUM_TOL = 1e-5
FAST_TOL = 1e-3                                   # sum-order rounding, [0, 255] inputs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("mode", ["full", "next", "none"])
@pytest.mark.parametrize("shape", [(3, 480, 752), (3, 240, 376), (3, 120, 188),
                                   (2, 61, 87)])
def test_grad_blur_kernel_matches_plain(dev, shape, mode):
    """Each mode against its plain version: the same shapes (the next level
    is (B, ceil(H/2), ceil(W/2))), values within GRAD_TOL."""
    from flvis_tpu_torch.ops.kernels import gradpyr

    x = torch.as_tensor(np.random.default_rng(0).uniform(0, 255, shape),
                        dtype=torch.float32, device=dev)
    before = gradpyr.grad_blur_kernel.launches
    got = gradpyr.grad_blur(x, mode)
    ref = gradpyr.grad_blur_plain(x, mode)
    torch.cuda.synchronize()
    assert gradpyr.grad_blur_kernel.launches == before + 1
    assert (got[2] is None) == (ref[2] is None) == (mode == "none")
    for a, b in zip(got, ref):
        if b is not None:
            assert a.shape == b.shape and a.is_contiguous()
            assert float((a - b).abs().max()) <= GRAD_TOL


@pytest.mark.parametrize("shape", [(3, 480, 752), (2, 61, 87), (97, 131)])
def test_grad_pyramid_on_card_matches_plain(dev, shape):
    """build_grad_pyramid on the card against the plain pyramid on the same
    image, one grad_blur launch per level and nothing else between them."""
    from flvis_tpu_torch.ops import image as imops
    from flvis_tpu_torch.ops.kernels import gradpyr

    x = np.random.default_rng(2).uniform(0, 255, shape).astype(np.float32)
    before = gradpyr.grad_blur_kernel.launches
    got = imops.build_grad_pyramid(torch.as_tensor(x, device=dev), 3)
    torch.cuda.synchronize()
    assert gradpyr.grad_blur_kernel.launches == before + 3
    ref = imops.build_grad_pyramid(torch.as_tensor(x), 3)
    for gl, rl in zip(got, ref):
        for a, b in zip(gl, rl):
            assert tuple(a.shape) == tuple(b.shape)
            assert float((a.cpu() - b).abs().max()) <= GRAD_TOL


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
    with pytest.raises(ValueError, match="mode"):
        gradpyr.grad_blur(torch.zeros((1, 8, 8), device=dev), "half")
    W, L = 17, 8
    args = [torch.zeros(s, device=dev) for s in
            ((W, 9), (W, 3), (3, L), (3 * W, L), (W, L), (W, L), (W,), (5,), ())]
    with pytest.raises(ValueError, match="window"):
        schur.schur_step(*args, 2.0)


def test_slice_launches_both_kernels(dev):
    """A few frames of SlamSystem on the card at a small config: every frame
    tracks, and the captured step's replays — read from the device, by
    kernel name, since a replay runs no wrapper — launch grad_blur once per
    pyramid level per frame and the keyframe BA's schur_step; no wrapper
    counts a launch during the replays."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    imgs0, imgs1 = (np.stack([f[k] for f in frames]) for k in (0, 1))
    slam = SlamSystem(cfg, cam, device=dev)
    slam._captured_step("stereo", (torch.as_tensor(imgs0, device=dev),
                                   torch.as_tensor(imgs1, device=dev)))
    g0, s0 = gradpyr.grad_blur_kernel.launches, schur.schur_step_kernel.launches
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        out = slam.process_frames(imgs0, imgs1)
        torch.cuda.synchronize()
    names = [e.name for e in p.events() if e.device_type == DeviceType.CUDA]
    assert (out.status == 1).all()
    assert sum("grad_blur_kernel" in n for n in names) == 3 * len(frames)
    assert sum("schur_reduce_solve" in n for n in names) >= 1
    assert (gradpyr.grad_blur_kernel.launches, schur.schur_step_kernel.launches) == (g0, s0)
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


IMU_CASES = ("init_only", "straddle", "steady", "masked", "ring_wrap", "odd_ring", "big_ring")
# Ring sizes by case: the kernel copies a ring of C % 4 == 0 slots in 16-byte
# loads, others in 4-byte loads, and one of more than 448 slots in more than
# one pass (the newest row then loaded on its own).
IMU_CAPACITY = {"ring_wrap": 24, "odd_ring": 30, "big_ring": 1000}


def imu_case(name):
    """(VioConfig kwargs, packets (acc, gyro, t, valid or None)) of numpy
    float32 IMU data from a seed: an init-only packet; a packet that
    straddles init_samples with two masked rows; steady dynamic packets;
    packets suffix-padded with invalid rows (one all invalid); a ring of 24
    slots that the packets wrap; the same packets on rings of 30 and 1000
    slots."""
    rng = np.random.default_rng(11 + IMU_CASES.index(name))
    kw = dict(imu_capacity=IMU_CAPACITY.get(name, 64), init_samples=20)
    clock = [0.0]

    def samples(n, dynamic=False, n_valid=None, masked=()):
        t = clock[0] + 0.005 * np.arange(1, n + 1)
        acc = np.tile([0.3, -0.2, 9.78], (n, 1)) + rng.normal(0.0, 0.02, (n, 3))
        gyro = rng.normal(0.0, 0.002, (n, 3)) + [0.004, -0.003, 0.002]
        if dynamic:
            acc = acc + rng.normal([0.4, -0.2, -0.2], 0.3, (n, 3))
            gyro = gyro + rng.normal(0.03, 0.15, (n, 3)) + [0.0, 0.0, 0.5]
        valid = None
        if n_valid is not None:           # suffix padding, as runner.pack_imu_frames
            valid = np.arange(n) < n_valid
            t[n_valid:], acc[n_valid:], gyro[n_valid:] = 0.0, 0.0, 0.0
        if masked:
            valid = np.ones(n, bool)
            valid[list(masked)] = False
        clock[0] = float(t.max()) if t.max() > 0 else clock[0]
        return (acc.astype(np.float32), gyro.astype(np.float32), t.astype(np.float32), valid)

    def wrapping():
        return ([samples(16), samples(16, masked=(2, 7))]
                + [samples(16, dynamic=True) for _ in range(4)])

    packets = {
        "init_only": lambda: [samples(12)],
        "straddle": lambda: [samples(12), samples(16, masked=(3, 9))],
        "steady": lambda: [samples(30)] + [samples(16, dynamic=True) for _ in range(3)],
        "masked": lambda: [samples(30), samples(16, True, n_valid=11), samples(16, True),
                           samples(16, n_valid=0)],
        "ring_wrap": wrapping, "odd_ring": wrapping, "big_ring": wrapping,
    }[name]()
    return kw, packets


def _imu_fields_close(got, ref):
    """The fused feed's state against the plain one: the attitude within
    IMU_TOL, pos and vel within IMU_SUM_TOL, every other field exact."""
    from flvis_tpu_torch.ops.kernels import imu_chain

    for k in imu_chain.FEED_FIELDS:
        a, b = getattr(got, k), getattr(ref, k)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == "q":
            assert float((a - b).abs().max()) <= IMU_TOL, k
        elif k in ("pos", "vel"):
            assert float((a - b).abs().max()) <= IMU_SUM_TOL, k
        else:
            assert torch.equal(a, b), k


@pytest.mark.parametrize("case", IMU_CASES)
def test_imu_feed_kernel_matches_plain(dev, case):
    """vimotion.imu_feed_batch on a CUDA state (the fused kernel, one launch
    a packet) against imu_feed_batch_plain on the card, packet by packet;
    the caller's state is left as it was."""
    from flvis_tpu_torch.config import VioConfig
    from flvis_tpu_torch.ops.kernels import imu_chain
    from flvis_tpu_torch.vio import vimotion

    kw, packets = imu_case(case)
    cfg = VioConfig(**kw)
    sk = sp = vimotion.init_state(cfg, device=dev)
    for acc, gyro, t, valid in packets:
        args = [torch.as_tensor(x, device=dev) for x in (acc, gyro, t)]
        args.append(None if valid is None else torch.as_tensor(valid, device=dev))
        old = {k: getattr(sk, k).clone() for k in imu_chain.FEED_FIELDS}
        n0 = imu_chain.imu_feed_kernel.launches
        new = vimotion.imu_feed_batch(cfg, sk, *args)
        sp = vimotion.imu_feed_batch_plain(cfg, sp, *args)
        torch.cuda.synchronize()
        assert imu_chain.imu_feed_kernel.launches == n0 + 1
        assert all(torch.equal(getattr(sk, k), v) for k, v in old.items())
        _imu_fields_close(new, sp)
        sk = new
    assert bool(sk.initialized) == (case != "init_only")


def test_imu_feed_one_launch_no_host_sync(dev):
    """Init, transition, masked, steady and all-invalid packets: each
    imu_feed_batch call is one kernel launch and no host synchronisation."""
    from flvis_tpu_torch.config import VioConfig
    from flvis_tpu_torch.ops.kernels import imu_chain
    from flvis_tpu_torch.vio import vimotion

    for case in ("straddle", "masked"):
        kw, packets = imu_case(case)
        cfg = VioConfig(**kw)
        st = vimotion.init_state(cfg, device=dev)
        dev_packets = [[None if x is None else torch.as_tensor(x, device=dev) for x in p]
                       for p in packets]
        vimotion.imu_feed_batch(cfg, st, *dev_packets[0])     # the library is loaded
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for p in dev_packets:
                n0 = imu_chain.attitude_chain_kernel.launches
                st = vimotion.imu_feed_batch(cfg, st, *p)
                assert imu_chain.attitude_chain_kernel.launches == n0 + 1
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert bool(st.initialized)


@pytest.mark.parametrize("shape", [(480, 752), (61, 87), (45, 131)])
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


@pytest.mark.parametrize("kind", ["flat", "tile_edges", "u8_noise"])
def test_fastblur_kernel_corner_cases(dev, kind):
    """A flat image (every score 0: NMS all ties), squares with corners on
    and beside the kernel's tile edges (126 columns by 11 rows), and an
    integer-valued image as the loop node feeds it: the same corner set,
    scores and blur within FAST_TOL."""
    from flvis_tpu_torch.ops.kernels import fastblur

    rng = np.random.default_rng(3)
    H, W = 480, 752
    if kind == "flat":
        img = np.full((H, W), 100.0)
    elif kind == "tile_edges":
        img = np.full((H, W), 40.0)
        for x in (126 * k + d for k in range(1, 6) for d in (-3, -1, 0, 2)):
            for y in (11 * m + d for m in range(2, 43, 2) for d in (-2, 0, 1)):
                img[y:y + 4, x:x + 4] = 220.0
    else:
        img = rng.integers(0, 256, (H, W))
    img = torch.as_tensor(img, dtype=torch.float32, device=dev)
    s_k, b_k = fastblur.fast_score_nms_blur(img, 20.0, 20)
    s_p, b_p = fastblur.fast_score_nms_blur_plain(img, 20.0, 20)
    torch.cuda.synchronize()
    assert torch.equal(s_k > 0, s_p > 0)
    assert (int((s_p > 0).sum()) == 0) == (kind == "flat")
    assert float((s_k - s_p).abs().max()) <= FAST_TOL
    assert float((b_k - b_p).abs().max()) <= FAST_TOL


@pytest.mark.parametrize("shape", [(240, 376), (37, 50), (45, 131)])
def test_sweep_kernel_matches_plain(dev, shape):
    """Same costs in the same add order, the same minima: the maps agree
    exactly."""
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
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _sweep_pair(dev, h, w, shift, seed):
    """A float texture (2×2 means of uniform noise: not quantised) as L and,
    as R, the same texture `shift` columns further on plus noise, so that
    L(x) ≈ R(x − shift)."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, (h + 1, w + shift + 1))
    tex = 0.25 * (tex[:-1, :-1] + tex[1:, :-1] + tex[:-1, 1:] + tex[1:, 1:])
    f = dict(dtype=torch.float32, device=dev)
    L = torch.as_tensor(tex[:, :w], **f).contiguous()
    R = torch.as_tensor(tex[:, shift:shift + w] + rng.normal(0, 1.0, (h, w)), **f).contiguous()
    return L, R


@pytest.mark.parametrize("shape", [(240, 376), (37, 50), (45, 131)])
def test_sweep_kernel_exact_on_float_images(dev, shape):
    from flvis_tpu_torch.ops.kernels import sweep

    h, w = shape
    L, R = _sweep_pair(dev, h, w, 12, h * w)
    before = sweep.sweep_maps_kernel.launches
    got = sweep.sweep_maps(L, R)
    ref = sweep.sweep_maps_plain(L, R)
    torch.cuda.synchronize()
    assert sweep.sweep_maps_kernel.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    inner = got[0][:, 4 + 12:w - 4]
    assert bool(got[2].any()) and float((inner.round() == 12).float().mean()) > 0.9


def test_sweep_kernel_flat_and_last_disparity(dev):
    """A flat pair: every cost ties at 0, so best = 0 and nothing is ok.  A
    pair 63 columns apart: best reaches D − 1 = 63 and is not ok there."""
    from flvis_tpu_torch.ops.kernels import sweep

    flat = torch.full((240, 376), 100.0, device=dev)
    got = sweep.sweep_maps(flat, flat.clone())
    ref = sweep.sweep_maps_plain(flat, flat.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert not bool(got[2].any()) and not bool(got[0].any()) and not bool(got[1].any())
    L, R = _sweep_pair(dev, 240, 376, 63, 7)
    got = sweep.sweep_maps(L, R)
    ref = sweep.sweep_maps_plain(L, R)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # best = 63 has no cost after it (cp = 0): the fit clamps to 63.5.
    far = got[0][:, 4 + 63:376 - 4]
    assert float((far == 63.5).float().mean()) > 0.9
    assert not bool(got[2][:, 4 + 63:376 - 4][far == 63.5].any())


@pytest.mark.parametrize("na,nb", [(1000, 1000), (17, 5), (130, 999)])
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
    # The kernel reads words one at a time: rows that start 4 bytes past a
    # 16-byte boundary are taken too.
    a4 = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(na, 8)
    b4 = torch.cat([b.new_zeros(1), b.flatten()])[1:].view(nb, 8)
    assert a4.data_ptr() % 16 and b4.data_ptr() % 16
    assert torch.equal(hamming.hamming_matrix(a4, b4), got)


def _match_inputs(rng, b, na, nb):
    """B pairs of descriptors for the match mode: half of a's rows near
    b's rows (3 bits flipped), b holding duplicate columns (ties in a row's
    top 2 and in a column's argmin), a row equidistant from two columns
    (d1 = d2), masked rows and columns, an all-invalid row and column."""
    a = rng.integers(0, 2 ** 32, (b, na, 8), dtype=np.uint32)
    bb = rng.integers(0, 2 ** 32, (b, nb, 8), dtype=np.uint32)
    for p in range(b):
        src = rng.permutation(nb)[: max(na // 2, 4)]
        for r, s in enumerate(src[:na]):
            a[p, r] = bb[p, s]
            for f in rng.integers(0, 256, 3):
                a[p, r, f // 32] ^= np.uint32(1 << (f % 32))
        bb[p, nb - 1] = bb[p, src[0]]
        if nb > 2:
            bb[p, nb - 2] = bb[p, src[1]]
        if na > 3 and nb > 4:
            a[p, 3] = bb[p, src[3]]
            bb[p, nb - 3] = bb[p, src[3]]
            bb[p, nb - 3, 0] ^= np.uint32(1)
            bb[p, src[3], 1] ^= np.uint32(1)
        a[p, na // 2:na // 2 + 4] = a[p, 0]             # duplicate rows: ties down a column
    va = rng.uniform(size=(b, na)) > 0.15
    vb = rng.uniform(size=(b, nb)) > 0.15
    va[:, 0] = vb[:, nb - 1] = True
    va[-1, na - 1] = False
    vb[-1, 0] = False
    if b > 1:
        va[1] = False                                   # a pair with no valid row

    def t(x):
        return torch.as_tensor(x.view(np.int32) if x.dtype == np.uint32 else x)

    return t(a), t(bb), t(va), t(vb)


MATCH_CASES = {"bucket8_1000": (8, 1000, 1000), "one_1000": (1, 1000, 1000),
               "ragged_17x5": (3, 17, 5), "ragged_1000x37": (2, 1000, 37),
               "ragged_37x1000": (2, 37, 1000), "two_columns": (2, 70, 2),
               "wide_40x9000": (2, 40, 9000)}


@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_hamming_match_kernel_exact(dev, case):
    """The match mode against mutual_ratio_match_plain on the card, every
    output bit for bit (ties, masks, all-invalid rows), one launch a call
    that leaves its scratch (column keys, last-block tickets) as it found
    it, and a repeat of the bucket giving the same outputs."""
    from flvis_tpu_torch.ops.kernels import hamming

    b, na, nb = MATCH_CASES[case]
    args = [x.to(dev) for x in _match_inputs(np.random.default_rng(na + nb), b, na, nb)]
    before = hamming.mutual_ratio_match_kernel.launches
    got = hamming.mutual_ratio_match(*args, ratio=0.75, max_distance=64)
    again = hamming.mutual_ratio_match(*args, ratio=0.75, max_distance=64)
    ref = hamming.mutual_ratio_match_plain(*args, ratio=0.75, max_distance=64)
    torch.cuda.synchronize()
    assert hamming.mutual_ratio_match_kernel.launches == before + 2
    colkey, tickets = hamming._SCRATCH[(dev.index, torch.cuda.current_stream(dev).cuda_stream)]
    assert not bool(tickets.any()) and bool((colkey == torch.iinfo(torch.int32).max).all())
    for name, g, a, r in zip(("best_ab", "good", "d1", "d2", "best_ba"), got, again, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.equal(g, r), name
        assert torch.equal(g, a), name
    d1, d2 = ref[2], ref[3]
    assert bool(((d1 == d2) & (d1 < 512)).any()) or nb == 2


@pytest.mark.parametrize("na, nb", [(300, 70000), (70000, 300)])
def test_hamming_match_past_16_bit_indices(dev, na, nb):
    """Past 65,535 columns or rows (the 16-bit index field the keys had):
    the match mode against its plain version bit for bit, with a mutual
    match planted at a column index (or a row index) above 65,535."""
    from flvis_tpu_torch.ops.kernels import hamming

    a, b, va, vb = _match_inputs(np.random.default_rng(na + nb), 1, na, nb)
    i, j = (5, nb - 1000) if nb > na else (na - 1000, 5)
    a[0, i] = b[0, j]
    va[0, i] = vb[0, j] = True
    args = [x.to(dev) for x in (a, b, va, vb)]
    got = hamming.mutual_ratio_match(*args, ratio=0.75, max_distance=64)
    ref = hamming.mutual_ratio_match_plain(*args, ratio=0.75, max_distance=64)
    for name, g, r in zip(("best_ab", "good", "d1", "d2", "best_ba"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.equal(g, r), name
    best_ab, good = ref[0], ref[1]
    if nb > na:
        assert bool((good & (best_ab > 65535)).any())
    else:
        assert bool(good[:, 65536:].any()) and int(ref[4][0, j]) == i


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
    d3 = torch.zeros((2, 10, 8), dtype=torch.int32, device=dev)
    v2 = torch.ones((2, 10), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        hamming.mutual_ratio_match_kernel(d3.cpu(), d3.cpu(), v2.cpu(), v2.cpu())
    with pytest.raises(ValueError, match="int32"):
        hamming.mutual_ratio_match(d3.float(), d3, v2, v2)
    with pytest.raises(ValueError, match=r"\(B, N, 8\)"):
        hamming.mutual_ratio_match(d3[0], d3[0], v2[0], v2[0])
    with pytest.raises(ValueError, match="bool"):
        hamming.mutual_ratio_match(d3, d3, v2.to(torch.uint8), v2)
    with pytest.raises(ValueError, match="valid_b"):
        hamming.mutual_ratio_match(d3, d3, v2, v2[:, :5])
    with pytest.raises(ValueError, match="pairs"):
        hamming.mutual_ratio_match(d3, d3[:1], v2, v2[:1])
    with pytest.raises(ValueError, match="Nb"):
        hamming.mutual_ratio_match(d3, d3[:, :1].contiguous(), v2, v2[:, :1].contiguous())
    d3_4 = torch.zeros(d3.numel() + 1, dtype=torch.int32, device=dev)[1:].view(2, 10, 8)
    assert d3_4.is_contiguous() and d3_4.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        hamming.mutual_ratio_match(d3, d3_4, v2, v2)
    big = torch.zeros((1, hamming.MAX_N + 1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="Na"):
        hamming.mutual_ratio_match(big, d3[:1], torch.ones((1, hamming.MAX_N + 1),
                                                           dtype=torch.bool, device=dev),
                                   v2[:1])
    with pytest.raises(ValueError, match="expected q0"):
        imu_chain.attitude_chain(torch.zeros(4, device=dev), torch.zeros((3, 4), device=dev),
                                 torch.zeros((2, 3), device=dev), torch.zeros(3, device=dev))
    from flvis_tpu_torch.config import VioConfig
    from flvis_tpu_torch.vio import vimotion

    cfg = VioConfig(imu_capacity=24)
    st = vimotion.init_state(cfg, device=dev)
    z3, z1 = torch.zeros((4, 3), device=dev), torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="packet"):
        vimotion.imu_feed_batch(cfg, st, torch.zeros((4, 2), device=dev), z3, z1)
    with pytest.raises(ValueError, match="packet"):
        vimotion.imu_feed_batch(cfg, st, z3[:0], z3[:0], z1[:0])
    with pytest.raises(ValueError, match="bool"):
        vimotion.imu_feed_batch(cfg, st, z3, z3, z1, z1)
    with pytest.raises(ValueError, match="CUDA"):
        vimotion.imu_feed_batch(cfg, st, z3.cpu(), z3, z1)


def test_vio_loop_path_launches_its_kernels(dev):
    """The stereo + IMU + loop path at the small config of
    tests/test_torch_runner.py: imu_chain on every IMU-initialised frame
    (inside the captured step's replays, so counted from the device's
    kernel events: a replay runs no wrapper), fastblur and sweep on every
    keyframe, hamming's match mode on every bucket of verifications (the
    eager loop node, counted by the wrappers)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
               sweep.sweep_maps_kernel, hamming.mutual_ratio_match_kernel)
    slam = SlamSystem(cfg, cam, device=dev, use_imu=True, use_loop=True)
    imgs0, imgs1 = (np.stack([f[k] for f in frames]) for k in (0, 1))
    z = functools.partial(torch.zeros, device=dev)
    slam._captured_step("vio", (torch.as_tensor(imgs0[:1], device=dev),
                                torch.as_tensor(imgs1[:1], device=dev), z(1), z((1, 16, 3)),
                                z((1, 16, 3)), z((1, 16)), z((1, 16), dtype=torch.bool)))
    before = [k.launches for k in kernels]
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        out = slam.process_frames_vio(imgs0, imgs1, ts=frame_t, imu_acc=accs, imu_gyro=gyros,
                                      imu_t=imuts)
        slam.flush_loop()           # the chunk's loop gate resolves a chunk late
        torch.cuda.synchronize()
    d = [k.launches - b for k, b in zip(kernels, before)]
    # Every imu_chain launch, in the graph or not: its kernels' device events.
    d[0] = sum(e.device_type() == DeviceType.CUDA
               and ("imu_feed_kernel" in e.name() or "attitude_chain_kernel" in e.name())
               for e in p.profiler.kineto_results.events())
    n_kf = int(out.is_keyframe.sum())
    init_frames = int(np.sum(np.cumsum([len(t) for t in imuts])[:-1] >= cfg.vio.init_samples))
    assert (out.status[1:] == 1).all()
    assert d[0] >= init_frames > 0
    assert d[1] >= n_kf and d[2] >= n_kf and n_kf == slam.loop_closer.count
    # The match mode: one launch a bucket of up to 8 verified pairs.
    n_cl = len(slam.loop_closer.closures)
    assert n_cl >= 1 and d[3] >= -(-n_cl // 8)


@pytest.mark.parametrize("shape,size,pad,n", [
    ((480, 752), 39, 39, 256),        # LK level-0 search windows
    ((3, 480, 752), 22, 12, 256),     # LK level-0 template blocks (img, gx, gy)
    ((480, 752), 27, 14, 1000),       # ORB patches
    ((2, 37, 50), 9, 3, 7),           # odd N, small image
])
def test_gather_kernel_exact(dev, shape, size, pad, n):
    """A copy: kernel and plain version agree bit for bit, corners beyond
    both clamp limits included."""
    from flvis_tpu_torch.ops.kernels import gather

    rng = np.random.default_rng(n)
    img = torch.as_tensor(rng.uniform(0, 255, shape), dtype=torch.float32, device=dev)
    h, w = shape[-2:]
    cx = torch.as_tensor(rng.integers(-5, w + 2 * pad + 5, n), device=dev)
    cy = torch.as_tensor(rng.integers(-5, h + 2 * pad + 5, n), device=dev)
    cx[:2] = torch.tensor([0, w + 2 * pad - size], device=dev)
    before = gather.gather_windows_kernel.launches
    got = gather.gather_windows(img, cx, cy, size, pad)
    ref = gather.gather_windows_plain(img, cx, cy, size, pad)
    torch.cuda.synchronize()
    assert gather.gather_windows_kernel.launches == before + 1
    assert got.shape == ref.shape and torch.equal(got, ref)


@pytest.mark.parametrize("b,n,v", [(8, 1000, 4096), (3, 37, 1000), (2, 50, 8192)])
def test_bowassign_kernel_exact(dev, b, n, v):
    """Term frequencies equal the ±1-matmul plain version exactly, with
    ties forced by duplicated words and some invalid descriptors, at any
    vocabulary size (8192 words: LoopConfig(vocab_words=8192)); the
    normalised rows of transform_rows follow."""
    from flvis_tpu_torch.loop import bow
    from flvis_tpu_torch.ops import orb
    from flvis_tpu_torch.ops.kernels import bowassign

    rng = np.random.default_rng(v)
    words = rng.integers(0, 2 ** 32, (v, 8), dtype=np.uint32)
    words[v // 2:v // 2 + 20] = words[3:23]                   # duplicated words: ties
    desc = rng.integers(0, 2 ** 32, (b, n, 8), dtype=np.uint32)
    desc[:, :10] = words[None, 3:13]                          # exact hits on tied words
    valid = torch.as_tensor(rng.uniform(size=(b, n)) > 0.1, device=dev)
    words_t = torch.as_tensor(words.view(np.int32), device=dev)
    desc_t = torch.as_tensor(desc.view(np.int32), device=dev)
    before = bowassign.bow_tf_kernel.launches
    got = bowassign.bow_tf(desc_t, valid, words_t)
    ref = bowassign.bow_tf_plain(desc_t, valid, words_t)
    torch.cuda.synchronize()
    assert bowassign.bow_tf_kernel.launches == before + 1
    assert torch.equal(got, ref) and int(got.sum()) == int(valid.sum())
    vocab = bow.Vocabulary(orb.unpack_pm1(words_t), torch.ones(v, device=dev))
    assert torch.equal(vocab.words_packed, words_t)
    assert torch.equal(bowassign.bow_tf(desc_t, valid, words_t, words_i8=vocab.words_i8), ref)
    rows = bow.transform_rows(vocab, desc_t, valid)
    tf = ref.to(torch.float32)
    assert torch.equal(rows, tf / torch.clamp(tf.sum(1, keepdim=True), min=1e-9))


def test_slice_three_kernel_wrappers_refuse_bad_input(dev):
    from flvis_tpu_torch.ops.kernels import bowassign, gather

    c = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        gather.gather_windows(torch.zeros((8, 8), dtype=torch.float64, device=dev), c, c, 3, 1)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        gather.gather_windows(torch.zeros((1, 1, 8, 8), device=dev), c, c, 3, 1)
    with pytest.raises(ValueError, match="does not fit"):
        gather.gather_windows(torch.zeros((8, 8), device=dev), c, c, 12, 1)
    d = torch.zeros((2, 5, 8), dtype=torch.int32, device=dev)
    w = torch.zeros((16, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bool"):
        bowassign.bow_tf(d, torch.ones((2, 5), dtype=torch.uint8, device=dev), w)
    with pytest.raises(ValueError, match=r"words_i8 must be \(16, 256\)"):
        bowassign.bow_tf(d, torch.ones((2, 5), dtype=torch.bool, device=dev), w,
                         words_i8=torch.zeros((8, 256), dtype=torch.int8, device=dev))


def _clamp_edge_corners(rng, n, dim, size, pad):
    """Corners over [-5, dim + 2 pad - size + 5], every clamp edge included."""
    c = rng.integers(-5, dim + 2 * pad - size + 6, n)
    edges = [-5, 0, dim + 2 * pad - size, dim + 2 * pad - size + 5]
    c[:min(n, 4)] = edges[:min(n, 4)]
    return c


@pytest.mark.parametrize("size", [22, 27, 39])
@pytest.mark.parametrize("n", [1, 255, 1000])
def test_gather_modes_exact(dev, size, n):
    """Both modes equal their plain versions bit for bit on one plane, a
    (3, H, W) stack and three separate planes, corners and centres on every
    clamp edge and off the image; each launch counts once."""
    from flvis_tpu_torch.ops.kernels import gather

    rng = np.random.default_rng(size * n)
    h, w = 480, 752
    stack = torch.as_tensor(rng.uniform(0, 255, (3, h, w)), dtype=torch.float32, device=dev)
    planes = tuple(p.contiguous() for p in stack)
    pad = size // 2
    cx = torch.as_tensor(_clamp_edge_corners(rng, n, w, size, pad), device=dev)
    cy = torch.as_tensor(_clamp_edge_corners(rng, n, h, size, pad)[::-1].copy(), device=dev)
    r = (size - 1) // 2
    cen = rng.uniform([-6.0, -6.0], [w + 6.0, h + 6.0], (n, 2))
    cen[:min(n, 4)] = [[-1.5, h + 3.5], [w + 0.0, -1.0], [0.0, 0.0], [w - 1.0, h - 1.0]][:min(n, 4)]
    cen = torch.as_tensor(cen, dtype=torch.float32, device=dev)
    before = gather.gather_windows_kernel.launches
    for img in (stack[0], stack, planes):
        got = gather.gather_windows(img, cx, cy, size, pad)
        ref = gather.gather_windows_plain(img, cx, cy, size, pad)
        gp = gather.gather_patches(img, cen, r)
        rp = gather.gather_patches_plain(img, cen, r)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.equal(got, ref)
        assert gp.shape == rp.shape and torch.equal(gp, rp)
    # strided corners and centres, as views of (N, 2) tensors
    both = torch.stack([cx, cy], -1)
    got = gather.gather_windows(stack, both[:, 0], both[:, 1], size, pad)
    cen_t = cen.T.contiguous().T
    gp = gather.gather_patches(planes, cen_t, r)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.gather_windows_plain(stack, cx, cy, size, pad))
    assert torch.equal(gp, gather.gather_patches_plain(planes, cen, r))
    assert gather.gather_windows_kernel.launches == before + 8


def _schur_args(dev, W, L, lam, seed=0, fixed_at=0, empty=None, n_kf=None):
    """Kernel arguments of a synthetic window: W poses along x looking at
    landmarks 4-14 m ahead, 60 % of the L slots live, each observed by a
    pose with probability 0.8 (pixel noise 0.5), stereo on 70 % of those;
    pose `fixed_at` fixed, pose `empty` without observations, and slots
    from `n_kf` on empty (a window of count n_kf)."""
    from flvis_tpu_torch.geometry import so3

    rng = np.random.default_rng(seed)
    f = dict(dtype=torch.float32, device=dev)
    q = so3.exp(torch.as_tensor(rng.normal(0, 0.02, (W, 3)), **f))
    R = so3.to_matrix(q).reshape(W, 9).contiguous()
    t = torch.as_tensor(np.stack([-0.1 * np.arange(W), rng.normal(0, 0.01, W),
                                  rng.normal(0, 0.01, W)], -1), **f).contiguous()
    pw = torch.as_tensor(rng.uniform([-4, -3, 4], [4, 3, 14], (L, 3)).T, **f).contiguous()
    fx, fy, cx, cy, b = 458.0, 458.0, 376.0, 240.0, 0.11
    pc = torch.einsum("wab,bl->wal", R.reshape(W, 3, 3), pw) + t[:, :, None]
    u = fx * pc[:, 0] / pc[:, 2] + cx
    v = fy * pc[:, 1] / pc[:, 2] + cy
    ur = fx * (pc[:, 0] - b) / pc[:, 2] + cx
    obs3 = (torch.stack([u, v, ur], 1)
            + torch.as_tensor(rng.normal(0, 0.5, (W, 3, L)), **f)).reshape(3 * W, L).contiguous()
    live = rng.uniform(size=L) < 0.6
    wm = (rng.uniform(size=(W, L)) < 0.8) & live[None]
    if empty is not None:
        wm[empty] = False
    if n_kf is not None:
        wm[n_kf:] = False
    urv = wm & (rng.uniform(size=(W, L)) < 0.7)
    fixed = np.zeros(W)
    fixed[fixed_at] = 1.0
    args = (R, t, pw, obs3, torch.as_tensor(urv, **f), torch.as_tensor(wm, **f),
            torch.as_tensor(fixed, **f), torch.tensor([fx, fy, cx, cy, fx * b], **f),
            torch.tensor(lam, **f))
    return args, q, torch.as_tensor(wm.any(0), device=dev)


def _check_schur(dev, args, q, observed):
    from flvis_tpu_torch.geometry import se3
    from flvis_tpu_torch.ops.kernels import schur

    before = schur.schur_step_kernel.launches
    dp, dl = schur.schur_step(*args, 2.0)
    dp2, dl2 = schur.schur_step_kernel(*args, 2.0)
    pdp, pdl = schur.schur_step_plain(*args, 2.0)
    torch.cuda.synchronize()
    assert schur.schur_step_kernel.launches == before + 2
    assert torch.equal(dp, dp2) and torch.equal(dl, dl2)          # fixed-order sums
    assert bool(torch.isfinite(dp).all()) and bool(torch.isfinite(dl).all())
    T = se3.SE3(q, args[1])
    Pk, Pp = se3.retract_left(T, dp), se3.retract_left(T, pdp)
    assert float((Pk.t - Pp.t).abs().max()) <= SCHUR_TOL["t"]
    assert float((Pk.q - Pp.q).abs().max()) <= SCHUR_TOL["q"]
    if bool(observed.any()):
        assert float((dl.T[observed] - pdl.T[observed]).abs().max()) <= SCHUR_TOL["lm"]
    return dp


@pytest.mark.parametrize("W", [1, 3, 10, 16])
@pytest.mark.parametrize("L", [1, 1000, 1024])
@pytest.mark.parametrize("lam", [1e-3, 1e-1])
def test_schur_kernel_windows(dev, W, L, lam):
    args, q, observed = _schur_args(dev, W, L, lam, seed=W * L)
    _check_schur(dev, args, q, observed)


@pytest.mark.parametrize("case", ["fixed_not_first", "unobserved_pose", "count_below_3"])
def test_schur_kernel_edge_windows(dev, case):
    """The fixed pose elsewhere than slot 0; a pose with no observation; a
    window of count 2 in 10 slots (window_ba.optimize runs the step there
    too).  Poses without observations keep dp = 0."""
    kw = {"fixed_not_first": dict(fixed_at=6), "unobserved_pose": dict(empty=4),
          "count_below_3": dict(n_kf=2)}[case]
    args, q, observed = _schur_args(dev, 10, 1024, 1e-3, seed=7, **kw)
    dp = _check_schur(dev, args, q, observed)
    unobserved = args[5].sum(1) == 0
    assert torch.equal(dp[unobserved], torch.zeros_like(dp[unobserved]))
    assert torch.equal(dp[args[6] > 0.5], torch.zeros_like(dp[args[6] > 0.5]))


def test_schur_kernel_on_two_streams(dev):
    """Steps queued on two streams behind one gate, so that they run at
    once, give what the same steps give one after the other: each stream
    keeps its own last-block ticket."""
    from flvis_tpu_torch.ops.kernels import schur

    cases = [_schur_args(dev, 10, 1024, lam, seed=s)[0] for s, lam in ((1, 1e-3), (2, 1e-1))]
    ref = [schur.schur_step_kernel(*a, 2.0) for a in cases]
    torch.cuda.synchronize()
    gate, streams = torch.cuda.Stream(dev), [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    with torch.cuda.stream(gate):
        torch.cuda._sleep(50_000_000)           # holds both queues while they fill
        opened = torch.cuda.Event()
        opened.record()
    outs = [[], []]
    for s in streams:
        s.wait_event(opened)
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(schur.schur_step_kernel(*cases[i], 2.0))
    torch.cuda.synchronize()
    for i in range(2):
        for dp, dl in outs[i]:
            assert torch.equal(dp, ref[i][0]) and torch.equal(dl, ref[i][1])


def test_redesigned_wrappers_refuse_bad_input(dev):
    from flvis_tpu_torch.ops.kernels import gather, schur

    img = torch.zeros((3, 32, 40), device=dev)
    c = torch.zeros(4, dtype=torch.int64, device=dev)
    cen = torch.zeros((4, 2), device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_windows_kernel(img.cpu(), c, c, 3, 1)
    with pytest.raises(ValueError, match="int64"):
        gather.gather_windows(img, c.to(torch.int32), c, 3, 1)
    with pytest.raises(ValueError, match="one shape"):
        gather.gather_patches((img[0], img[1, :16]), cen, 2)
    with pytest.raises(ValueError, match="1 to 4"):
        gather.gather_patches(torch.zeros((5, 32, 40), device=dev), cen, 2)
    with pytest.raises(ValueError, match=r"\(N, 2\) float32"):
        gather.gather_patches(img, cen.double(), 2)
    with pytest.raises(ValueError, match=r"\(N, 2\) float32"):
        gather.gather_patches(img, cen.cpu(), 2)
    args, _, _ = _schur_args(dev, 3, 64, 1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        schur.schur_step_kernel(*[a.cpu() for a in args], 2.0)
    with pytest.raises(ValueError, match="float32"):
        schur.schur_step_kernel(*args[:2], args[2].double(), *args[3:], 2.0)
    with pytest.raises(ValueError, match="shape"):
        schur.schur_step_kernel(args[0], args[1][:2], *args[2:], 2.0)
    big, _, _ = _schur_args(dev, 17, 64, 1e-3)
    with pytest.raises(ValueError, match="window"):
        schur.schur_step_kernel(*big, 2.0)


@pytest.mark.parametrize("pallas_schur", [True, False])
def test_window_ba_wide_window_on_card(dev, pallas_schur):
    """window_size=20 on the card takes the plain Schur step: it warns once
    (silent with pallas_schur=False), launches no schur kernel, and equals
    the CPU's optimize within the Schur step's bounds."""
    import warnings

    import chip_smoke
    from flvis_tpu_torch.backend import window_ba
    from flvis_tpu_torch.config import BackendConfig
    from flvis_tpu_torch.ops.kernels import schur

    _, scfg = chip_smoke.system_config()
    bcfg = BackendConfig(window_size=20, pallas_schur=pallas_schur)
    out = []
    for d in (dev, torch.device("cpu")):
        cam = chip_smoke.make_camera(scfg, d)
        st = chip_smoke.bench_window(bcfg, cam, d)
        before = schur.schur_step_kernel.launches
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out.append(window_ba.optimize(bcfg, cam, st).state)
        warned = [w for w in rec if issubclass(w.category, RuntimeWarning)]
        assert schur.schur_step_kernel.launches == before
        assert len(warned) == (1 if d.type == "cuda" and pallas_schur else 0)
        if warned:
            assert "window_size=20" in str(warned[0].message)
    g, c = out
    assert float((g.kf_t.cpu() - c.kf_t).abs().max()) <= SCHUR_TOL["t"]
    assert float((g.kf_q.cpu() - c.kf_q).abs().max()) <= SCHUR_TOL["q"]
    live = c.lm_valid
    assert torch.equal(g.lm_valid.cpu(), live)
    assert float((g.lm_pw.cpu()[live] - c.lm_pw[live]).abs().max()) <= SCHUR_TOL["lm"]


def test_pgo_repeats_bit_for_bit(dev):
    """Dense PGO of a drifted 200-node chain with loop edges (one pair
    repeated) gives the same bits twice: its assembly sums in a fixed
    order, without float atomics."""
    from flvis_tpu_torch.geometry import so3
    from flvis_tpu_torch.loop import pose_graph

    rng = np.random.default_rng(0)
    K = 200
    seq = [(i, i + s) for s in (1, 2, 3) for i in range(K - s)]
    loops = [(int(a), int(a) + int(g)) for a, g in
             zip(rng.integers(0, K - 60, 24), rng.integers(30, 60, 24))]
    loops += [loops[0]] * 3
    ii, jj = (np.asarray(v, np.int64) for v in zip(*(seq + loops)))
    E = ii.shape[0]
    gt = np.stack([0.05 * np.arange(K), np.zeros(K), np.zeros(K)], -1)
    node_t = gt + np.stack([np.zeros(K), 0.004 * np.arange(K), np.zeros(K)], -1)
    f = dict(dtype=torch.float32, device=dev)
    g = pose_graph.PoseGraph(
        node_q=so3.exp(torch.as_tensor(rng.normal(0, 0.01, (K, 3)), **f)),
        node_t=torch.as_tensor(node_t, **f), node_valid=torch.ones(K, dtype=torch.bool, device=dev),
        edge_i=torch.as_tensor(ii, device=dev), edge_j=torch.as_tensor(jj, device=dev),
        edge_q=so3.exp(torch.as_tensor(rng.normal(0, 0.002, (E, 3)), **f)),
        edge_t=torch.as_tensor(gt[jj] - gt[ii] + rng.normal(0, 0.003, (E, 3)), **f),
        edge_valid=torch.ones(E, dtype=torch.bool, device=dev), edge_weight=torch.ones(E, **f))
    fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed[0] = True
    a, ca = pose_graph.optimize(g, fixed, iters=20)
    b, cb = pose_graph.optimize(g, fixed, iters=20)
    torch.cuda.synchronize()
    assert torch.equal(a.node_q, b.node_q) and torch.equal(a.node_t, b.node_t)
    assert torch.equal(ca, cb) and bool(torch.isfinite(a.node_t).all())
    assert not torch.equal(a.node_t, g.node_t)


def _loop_composition(dev):
    """The loop run of tests/test_torch_loop.py (a 28-keyframe out-and-back
    with 1 cm of drift per keyframe) through one LoopCloser on the card."""
    from flvis_tpu_torch.config import LoopConfig
    from flvis_tpu_torch.geometry import camera, so3
    from flvis_tpu_torch.geometry.se3 import SE3
    from flvis_tpu_torch.io.synthetic import PlanarScene, SceneConfig
    from flvis_tpu_torch.loop import loop_closing

    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
    kw = dict(max_keyframes=64, num_orb_features=200, vocab_words=128, kf_start=12,
              kf_dist=10, kf_max_dist=64, nkf_closest=2, min_pts=12, min_score=0.03,
              ratio_ransac=0.3, seq_edge_successors=3)
    cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline, width=scfg.width,
                      height=scfg.height, device=dev)
    lc = loop_closing.LoopCloser(LoopConfig(**kw), cam, device=dev)
    n = 28
    xs = list(np.linspace(0, 0.8, n // 2)) + list(np.linspace(0.8, 0.02, n - n // 2))
    for k, x in enumerate(xs):
        t = -np.asarray([x, 0.0, 0.0])
        img_l, img_r, _ = scene.render(np.eye(3), t)
        T = SE3(so3.from_matrix(torch.eye(3, device=dev)),
                torch.as_tensor(t + [0.0, 0.01 * k, 0.0], dtype=torch.float32, device=dev))
        idx = lc.add_keyframe(img_l, img_r, T, frame_id=k)
        if lc.detect_loop(idx) is not None:
            lc.optimize_graph()
    torch.cuda.synchronize()
    return lc


def test_loop_composition_repeats_bit_for_bit(dev):
    """Ingest, BoW, verification and PGO run twice in one process give the
    same closures, T_map_odom and keyframe poses, bit for bit."""
    a, b = _loop_composition(dev), _loop_composition(dev)
    assert len(a.closures) >= 1
    assert [(c.kf_i, c.kf_j, c.num_inliers) for c in a.closures] == \
        [(c.kf_i, c.kf_j, c.num_inliers) for c in b.closures]
    assert torch.equal(a.T_map_odom.q, b.T_map_odom.q)
    assert torch.equal(a.T_map_odom.t, b.T_map_odom.t)
    assert torch.equal(a.kf_q, b.kf_q) and torch.equal(a.kf_t, b.kf_t)
    assert torch.equal(a.bow_db, b.bow_db)


def _verify_store(dev, K=10, F=1000, seed=5):
    """A LoopCloser (LoopConfig() widths: 1000 features, 128 hypotheses) on
    the card whose store holds K keyframes over one set of F world points:
    keyframe k at x = 0.1·k with a small yaw, its features a permutation of
    the points with 4 descriptor bits flipped, 15 % outliers, masks; node
    poses with a drift of 0.01·k in y."""
    from flvis_tpu_torch.config import LoopConfig
    from flvis_tpu_torch.geometry import camera
    from flvis_tpu_torch.loop import loop_closing

    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = 458.0, 458.0, 376.0, 240.0
    lc = loop_closing.LoopCloser(LoopConfig(max_keyframes=K),
                                 camera.make(fx, fy, cx, cy, 0.11, width=752, height=480,
                                             device=dev), device=dev)
    X = rng.uniform([-3, -2, 4], [3.5, 2, 10], (F, 3))
    base = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32)
    for k in range(K):
        yaw = 0.02 * k
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
        C = np.array([0.1 * k, 0.0, 0.0])
        perm = rng.permutation(F)
        pc = (X[perm] - C) @ R
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
        d = base[perm].copy()
        for r, f in enumerate(rng.integers(0, 256, (F, 4))):
            for b in f:
                d[r, b // 32] ^= np.uint32(1 << (b % 32))
        out = rng.uniform(size=F) < 0.15
        d[out] = rng.integers(0, 2 ** 32, (int(out.sum()), 8), dtype=np.uint32)

        def put(name, x, dt=torch.float32):
            getattr(lc, name)[k] = torch.as_tensor(x, dtype=dt, device=dev)

        put("kf_desc", d.view(np.int32), torch.int32)
        put("kf_kp_valid", rng.uniform(size=F) > 0.05, torch.bool)
        put("kf_pc_valid", rng.uniform(size=F) > 0.1, torch.bool)
        put("kf_pc", pc)
        put("kf_uv", uv)
        put("kf_q", [np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
        put("kf_t", C + [0.0, 0.01 * k, 0.0])
    lc.count = K
    return lc


VERIFY_PAIRS = [(0, 5), (1, 6), (2, 7), (3, 8), (0, 9)]


def test_verify_device_batch_on_card_matches_per_pair(dev):
    """A bucket padded to 8 with its last pair through _verify_device_batch
    against each pair's own _verify_device (a bucket of one): n_match and
    n_inl exact, the pose and gate statistics within 1e-5."""
    lc = _verify_store(dev)
    bucket = VERIFY_PAIRS + VERIFY_PAIRS[-1:] * 3
    got = lc._verify_device_batch([i for i, _ in bucket], [j for _, j in bucket]).cpu()
    ref = torch.stack([lc._verify_device(i, j) for i, j in bucket]).cpu()
    assert got.shape == (8, 11)
    assert torch.equal(got[:, 7:9], ref[:, 7:9])
    assert float((got - ref).abs().max()) <= 1e-5
    assert (got[:5, 7] >= 100).all() and (got[:5, 8] >= 0.5 * got[:5, 7]).all()


def test_verify_bucket_one_launch_no_host_sync(dev):
    """One bucket of 8 pairs: one hamming launch (the match mode, none of
    the matrix mode) and no synchronising CUDA operation, under
    torch.cuda.set_sync_debug_mode("error"); dispatch_verify makes one
    bucket call per 8 candidates, the last holding only the real rest."""
    from flvis_tpu_torch.ops.kernels import hamming

    lc = _verify_store(dev)
    bucket = VERIFY_PAIRS + VERIFY_PAIRS[-1:] * 3
    iis, jjs = [i for i, _ in bucket], [j for _, j in bucket]
    lc._verify_device_batch(iis, jjs)                  # warm up: library load, cuBLAS handles
    torch.cuda.synchronize()
    before = (hamming.mutual_ratio_match_kernel.launches, hamming.hamming_matrix_kernel.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        lc._verify_device_batch(iis, jjs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (hamming.mutual_ratio_match_kernel.launches - before[0],
            hamming.hamming_matrix_kernel.launches - before[1]) == (1, 0)
    calls = []
    real = lc._verify_device_batch
    lc._verify_device_batch = lambda a, b: calls.append(len(a)) or real(a, b)
    cands = [(i, j) for i in range(4) for j in range(5, 10)][:11]
    rows = np.asarray([[i, 1.0, 10.0, 0.0] for i, _ in cands], np.float32)
    ks = [j for _, j in cands]
    handle = lc.dispatch_verify(("rows", ks, [0] * 11, [10] * 11, None), rows)
    assert calls == [8, 3] and handle[1] == cands and tuple(handle[2].shape) == (11, 11)


# ------------------------------------------------ the captured frame step
def _entry_system(dev, **frontend):
    """The port's config at the entry configuration's widths
    (__graft_entry__._small_cfg: 256×192, 64 slots) with a 5-keyframe
    window, and its camera on dev."""
    from flvis_tpu_torch.config import BackendConfig, FrontendConfig, SystemConfig
    from flvis_tpu_torch.geometry import camera

    cfg = SystemConfig(
        frontend=FrontendConfig(width=256, height=192, num_slots=64, pyramid_levels=3,
                                per_cell=4, min_distance=10.0, margin=12, lk_radius=7,
                                lk_iters=6, ransac_hypotheses=32, **frontend),
        backend=BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4))
    return cfg, camera.make(200.0, 200.0, 128.0, 96.0, 0.12, width=256, height=192, device=dev)


def _entry_frames(n=12, blank=(5, 6)):
    """n frames of an out-and-back pan (uint8, blank at `blank`: escaped,
    then FAIL, then re-init) and their IMU packets of at most 16 samples."""
    from flvis_tpu_torch.io.synthetic import PlanarScene, SceneConfig, imu_from_trajectory

    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                       baseline=0.12)
    xs = list(np.linspace(0, 0.3, n // 2)) + list(np.linspace(0.3, 0.02, n - n // 2))
    poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
    frames = [scene.render(R, t)[:2] for (R, t) in poses]
    imgs0 = np.stack([np.clip(f[0], 0, 255).astype(np.uint8) for f in frames])
    imgs1 = np.stack([np.clip(f[1], 0, 255).astype(np.uint8) for f in frames])
    imgs0[list(blank)] = 0
    imgs1[list(blank)] = 0
    t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
    imu, prev = ([], [], []), -np.inf
    for ft in frame_t:
        m = (t_imu > prev) & (t_imu <= ft)
        for lst, a in zip(imu, (acc, gyro, t_imu)):
            lst.append(a[m][-16:])
        prev = ft
    return imgs0, imgs1, np.asarray(frame_t), imu


def _chunks(slam, kind, frames, chunk):
    """Drive slam's process_frames[_vio] over `frames` in chunks; returns the
    stacked host FrameOutput fields."""
    imgs0, imgs1, ts, (acc, gyro, it) = frames
    outs = []
    for a in range(0, len(imgs0), chunk):
        sl = slice(a, a + chunk)
        if kind == "vio":
            outs.append(slam.process_frames_vio(imgs0[sl], imgs1[sl], ts[sl], acc[sl], gyro[sl],
                                                it[sl]))
        else:
            outs.append(slam.process_frames(imgs0[sl], imgs1[sl], ts[sl]))
    return outs


def _eager_chunks(slam, kind, frames, chunk):
    """The same chunks through the eager composition (run_chunk_eager over
    the module-level fused step) on slam's generator: the host
    FrameOutputs and BA costs."""
    slam._run_chunk = slam._run_chunk_eager
    return _chunks(slam, kind, frames, chunk), slam.ba_costs


def _assert_same_outputs(got, want):
    for f in ("status", "is_keyframe", "reset_backend", "num_inliers", "mean_reproj_err"):
        np.testing.assert_array_equal(np.concatenate([getattr(o, f) for o in got]),
                                      np.concatenate([getattr(o, f) for o in want]), err_msg=f)
    for f in ("q", "t"):
        np.testing.assert_array_equal(np.concatenate([getattr(o.T_c_w, f) for o in got]),
                                      np.concatenate([getattr(o.T_c_w, f) for o in want]),
                                      err_msg=f)


@pytest.mark.parametrize("kind", ["stereo", "vio"])
def test_captured_step_matches_eager(dev, kind):
    """process_frames[_vio] on the card (one captured graph a step, replayed
    a frame) against the eager composition on the same draws, over 12
    frames in chunks of 6 whose blank frames take the status cond's init
    side inside the graph: every output and BA cost bit for bit."""
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    cfg, cam = _entry_system(dev)
    frames = _entry_frames()
    kw = dict(device=dev, seed=0, use_imu=kind == "vio")
    slam = SlamSystem(cfg, cam, **kw)
    got = _chunks(slam, kind, frames, 6)
    want, costs = _eager_chunks(SlamSystem(cfg, cam, **kw), kind, frames, 6)
    _assert_same_outputs(got, want)
    assert slam.ba_costs == costs and len(costs) >= 2
    status = np.concatenate([o.status for o in got])
    assert status[6] == 2 and status[7] == 1                   # FAIL, then re-init
    assert [key[0] for key in slam._captured] == [kind]


def test_captured_replays_no_host_sync(dev):
    """After the capture, a chunk's replays (inputs copied in, draws made,
    outputs copied out) run under the sync debug mode's "error"."""
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    cfg, cam = _entry_system(dev)
    imgs0, imgs1, ts, imu = _entry_frames(blank=())
    slam = SlamSystem(cfg, cam, device=dev, seed=0, use_imu=True)
    _chunks(slam, "vio", (imgs0[:4], imgs1[:4], ts[:4], tuple(x[:4] for x in imu)), 4)
    xs = [torch.as_tensor(a, device=dev) for a in (imgs0[4:], imgs1[4:])]
    xs.append(torch.as_tensor(ts[4:], dtype=torch.float32, device=dev))
    from flvis_tpu_torch.pipeline.runner import pack_imu_frames

    xs += [torch.as_tensor(a, device=dev) for a in pack_imu_frames(*(x[4:] for x in imu))]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed, pkts, cap = slam._run_chunk("vio", tuple(xs))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cap is slam._captured[("vio",) + tuple(x.dtype for x in xs)]
    assert cap.step.replays == len(imgs0)
    assert torch.isfinite(packed).all()


def test_rare_branches_inside_the_graph(dev):
    """The PnP rescue (min_inliers above the 64 slots: every tracking frame
    starves) and the re-initialisation run inside the graph — the taken
    counts of their IF nodes say so — with the eager composition's bits."""
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    cfg, cam = _entry_system(dev, min_inliers=65)
    imgs0, imgs1, ts, imu = _entry_frames(blank=())
    slam = SlamSystem(cfg, cam, device=dev, seed=0)
    xs = (torch.as_tensor(imgs0, device=dev), torch.as_tensor(imgs1, device=dev))
    packed, pkts, cap = slam._run_chunk("stereo", xs)
    slam._finish_chunk(packed, pkts, cap, xs[0], xs[1], None, len(imgs0))
    # The status cond (track | init) and the PnP rescue inside its track
    # side (rescue | keep).
    taken = cap.step.taken_by_name()
    assert taken["status"][1] >= 2 and taken["pnp_rescue"][0] >= 2
    assert sum(taken["status"]) == len(imgs0)
    want, _ = _eager_chunks(SlamSystem(cfg, cam, device=dev, seed=0), "stereo",
                            (imgs0, imgs1, ts, imu), len(imgs0))
    from flvis_tpu_torch.pipeline.runner import _unpack_outputs

    _assert_same_outputs([_unpack_outputs(packed.cpu().numpy())], want)


def test_two_systems_capture_side_by_side(dev):
    """Two systems, each with its own captured step and schur ticket,
    replaying at once on two streams (pipelined: a chunk's end waits for
    the next call): both give the eager composition's outputs."""
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    cfg, cam = _entry_system(dev)
    frames = _entry_frames(blank=())
    a, b = (SlamSystem(cfg, cam, device=dev, seed=0, pipelined=True) for _ in range(2))
    assert a._ticket.data_ptr() != b._ticket.data_ptr()
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    outs = ([], [])
    imgs0, imgs1, ts, _ = frames
    for c0 in range(0, 12, 4):
        for s, slam, st in zip((0, 1), (a, b), streams):
            with torch.cuda.stream(st):
                o = slam.process_frames(imgs0[c0:c0 + 4], imgs1[c0:c0 + 4], ts[c0:c0 + 4])
            if o is not None:
                outs[s].append(o)
    for s, slam, st in zip((0, 1), (a, b), streams):
        with torch.cuda.stream(st):
            outs[s].append(slam.flush())
    torch.cuda.synchronize()
    want, _ = _eager_chunks(SlamSystem(cfg, cam, device=dev, seed=0), "stereo", frames, 4)
    for got in outs:
        _assert_same_outputs(got, want)


def test_capture_failure_raises(dev, monkeypatch):
    """A host read inside the step makes its capture fail: process_frames
    raises in the capture's warm-up, before any capture begins, naming the
    operation, and nothing runs in the graph's place."""
    from flvis_tpu_torch.frontend import tracker
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    real = tracker._nanmedian

    def host_read(x, dim=None):
        out = real(x, dim)
        float(out.reshape(-1)[0])       # a device value read on the host
        return out

    monkeypatch.setattr(tracker, "_nanmedian", host_read)
    cfg, cam = _entry_system(dev)
    imgs0, imgs1, _, _ = _entry_frames(n=3, blank=())
    slam = SlamSystem(cfg, cam, device=dev, seed=0)
    with pytest.raises(RuntimeError, match="the stereo frame step cannot be captured into a "
                                           "CUDA graph: it reads the host at "
                                           "aten._local_scalar_dense"):
        slam.process_frames(imgs0, imgs1)
    assert slam._captured == {} and slam._frames_processed == 0


def test_captured_long_lm_loops_match_eager(dev):
    """iters1 = 120, iters2 = 10 — more LM steps than a capture held when
    each step was a cond of its own — capture (each LM phase one WHILE
    node) and replay with the eager composition's bits; the loops' taken
    counts hold their iterations."""
    import dataclasses

    from flvis_tpu_torch.pipeline.runner import SlamSystem

    cfg, cam = _entry_system(dev)
    cfg = cfg.replace(backend=dataclasses.replace(cfg.backend, iters1=120, iters2=10))
    frames = _entry_frames(blank=())
    slam = SlamSystem(cfg, cam, device=dev, seed=0)
    got = _chunks(slam, "stereo", frames, 6)
    want, costs = _eager_chunks(SlamSystem(cfg, cam, device=dev, seed=0), "stereo", frames, 6)
    _assert_same_outputs(got, want)
    assert slam.ba_costs == costs and len(costs) >= 2
    st = next(iter(slam._captured.values())).step
    loops = [x for x in st.sites if x["kind"] == "while"]
    assert [x["name"] for x in loops] == ["lm_loop", "lm_loop"] and len(st.sites) <= 8
    iterations, entries = st.taken_by_name()["lm_loop"]
    assert entries == 2 * len(costs) and iterations >= entries
    assert st.node_stats()[2] == iterations / st.replays


def _multiseq_inputs(frames, S, roll=7):
    """The entry frames as S sequences, the last rolled horizontally by
    `roll` px (so that it differs), with their IMU packets."""
    from flvis_tpu_torch.pipeline.runner import pack_imu_frames

    imgs0, imgs1, ts, imu = frames
    shift = [0] * (S - 1) + [roll]
    i0 = np.stack([np.roll(imgs0, k, axis=2) for k in shift])
    i1 = np.stack([np.roll(imgs1, k, axis=2) for k in shift])
    packed = pack_imu_frames(*imu, 16)
    return i0, i1, np.broadcast_to(ts.astype(np.float32), (S,) + ts.shape), [
        np.broadcast_to(a, (S,) + a.shape) for a in packed]


@pytest.mark.parametrize("ba_every", [1, 2])
@pytest.mark.parametrize("kind", ["stereo", "vio"])
def test_multiseq_captured_matches_eager(dev, kind, ba_every):
    """MultiSeqSlam(num_seqs=3) on the card — one captured graph a frame,
    the 3 sequences its branches — against its eager route over the same
    frames and draws, in chunks of 6 through the blank frames' FAIL and
    re-init: every packed output bit for bit, each sequence's generator as
    far on, sequences 0 and 1 (the same frames) equal, the rolled sequence
    2 not; no fallback to eager."""
    from flvis_tpu_torch.parallel.multiseq_loop import MultiSeqSlam

    S = 3
    cfg, cam = _entry_system(dev)
    i0, i1, ts, imu = _multiseq_inputs(_entry_frames(), S)
    runs = []
    for eager in (False, True):
        ms = MultiSeqSlam(cfg, cam, num_seqs=S, use_imu=kind == "vio", use_loop=False,
                          ba_every=ba_every, device=dev)
        if eager:
            ms._run_chunk = ms._run_chunk_eager
        outs = []
        for c in range(0, i0.shape[1], 6):
            sl = slice(c, c + 6)
            if kind == "vio":
                outs.append(ms.process_chunk_vio(i0[:, sl], i1[:, sl], ts[:, sl],
                                                 *(a[:, sl] for a in imu)))
            else:
                outs.append(ms.process_chunk(i0[:, sl], i1[:, sl], ts[:, sl]))
        runs.append((ms, np.concatenate(outs, axis=1)))
    (cap_ms, got), (eag_ms, want) = runs
    np.testing.assert_array_equal(got, want)
    for a, b in zip(cap_ms.generators, eag_ms.generators):     # the same draws consumed
        assert torch.equal(a.get_state(), b.get_state())
    assert set(cap_ms._captured) == {kind} and eag_ms._captured == {}
    st = cap_ms._captured[kind].step
    assert st.replays == i0.shape[1] and len({x["branch"] for x in st.sites}) == S
    np.testing.assert_array_equal(got[0], got[1])
    assert not np.array_equal(got[0, :, 9:12], got[2, :, 9:12])
    assert got[0, 6, 2] == 2 and (got[:, 7:, 2] == 1).all()          # FAIL, then re-init
    _, _, iterations = st.node_stats()
    assert iterations > 0


def _multiseq_run(dev, S, kind, ba_every, frames, chunk, eager=False, before_chunk=None):
    """MultiSeqSlam(num_seqs=S) at the entry configuration over `frames`
    (_multiseq_inputs) in chunks of `chunk`, captured or (eager) through its
    eager route; before_chunk(c, run) runs chunk c as it likes.  Returns
    (the system, its packed outputs (S, n, 14))."""
    from flvis_tpu_torch.parallel.multiseq_loop import MultiSeqSlam

    cfg, cam = _entry_system(dev)
    i0, i1, ts, imu = frames
    ms = MultiSeqSlam(cfg, cam, num_seqs=S, use_imu=kind == "vio", use_loop=False,
                      ba_every=ba_every, device=dev)
    if eager:
        ms._run_chunk = ms._run_chunk_eager
    outs = []
    for c in range(0, i0.shape[1], chunk):
        sl = slice(c, c + chunk)

        def run(sl=sl):
            if kind == "vio":
                outs.append(ms.process_chunk_vio(i0[:, sl], i1[:, sl], ts[:, sl],
                                                 *(a[:, sl] for a in imu)))
            else:
                outs.append(ms.process_chunk(i0[:, sl], i1[:, sl], ts[:, sl]))

        (before_chunk or (lambda c, run: run()))(c // chunk, run)
    return ms, np.concatenate(outs, axis=1)


def test_multiseq_profiled_after_an_earlier_trace(dev):
    """A captured MultiSeqSlam(num_seqs=3) chunk replayed under
    torch.profiler after earlier profiled runs in the process (CUPTI set up
    and torn down before, unless the port's default keeps it up): no
    illegal address, the replays' kernels in the trace, and the eager
    route's bits."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    a = torch.randn(64, 64, device=dev)
    for _ in range(2):
        with profile(activities=activities):
            a = torch.tanh(a @ a)
            torch.cuda.synchronize()
    frames = _multiseq_inputs(_entry_frames(), 3)
    events = []

    def profiled(c, run):
        if c == 0:
            return run()
        with profile(activities=activities) as p:
            run()
            torch.cuda.synchronize()
        events.append(sum(e.device_type().name == "CUDA"
                          for e in p.profiler.kineto_results.events()))

    cap_ms, got = _multiseq_run(dev, 3, "vio", 2, frames, 4, before_chunk=profiled)
    _, want = _multiseq_run(dev, 3, "vio", 2, frames, 4, eager=True)
    np.testing.assert_array_equal(got, want)
    assert cap_ms._captured["vio"].step.replays == 12 and len(events) == 2
    assert all(n > 1000 for n in events)


def test_multiseq_capture_holds_more_sites_than_a_block(dev):
    """MultiSeqSlam(num_seqs=20) VIO at ba_every 2: more conds and loops in
    the one graph (20 x ~7) than MAX_SITES, each branch's in its own block
    of taken counts; captured equal to eager bit for bit, each site's
    counts settled."""
    from flvis_tpu_torch.utils import control

    S = 20
    frames = _multiseq_inputs(_entry_frames(n=6, blank=()), S)
    cap_ms, got = _multiseq_run(dev, S, "vio", 2, frames, 6)
    _, want = _multiseq_run(dev, S, "vio", 2, frames, 6, eager=True)
    np.testing.assert_array_equal(got, want)
    st = cap_ms._captured["vio"].step
    assert len(st.sites) > control.MAX_SITES
    assert len({x["row"] for x in st.sites}) == len(st.sites)
    assert st.taken.shape[0] == control.MAX_SITES * (1 + S)
    assert st.taken_total.sum() > 0 and st.replays == 6


def test_released_capture_streams_are_reused(dev):
    """A CapturedStep's streams return to the pool when it is released, and
    the next capture takes them instead of making new ones; its replays
    stay right."""
    import gc

    from flvis_tpu_torch.utils import control

    def step(carry, xs):
        outs = control.branches(lambda k: carry[k] * 2 + xs[0], range(2))
        return tuple(outs), xs[0]

    def capture():
        carry = (torch.ones(8, device=dev), torch.full((8,), 3.0, device=dev))
        return control.CapturedStep(step, carry, (torch.ones((), device=dev),), name="pool",
                                    branches=2)

    n = control.CapturedStep.STREAMS * 3
    gc.collect()                # earlier tests' captures first
    free = control._FREE_STREAMS.setdefault(dev, [])
    before = len(free)
    cap = capture()
    held = len(free)
    del cap
    gc.collect()
    assert len(free) == held + n and held == max(before - n, 0)
    cap = capture()
    assert len(free) == held
    cap.replay()
    torch.cuda.synchronize()
    assert torch.equal(cap.carry[0], torch.full((8,), 3.0, device=dev))
    assert torch.equal(cap.carry[1], torch.full((8,), 7.0, device=dev))


def test_branches_with_schur_give_eager_bits(dev):
    """Two branches of one captured step, each solving its own window
    (schur kernel launches inside WHILE bodies, each branch with its own
    last-block ticket), replayed side by side: the eager solves' bits."""
    import chip_smoke
    from flvis_tpu_torch.backend import window_ba
    from flvis_tpu_torch.ops.kernels import schur
    from flvis_tpu_torch.utils import control
    from flvis_tpu_torch.utils.tree import tree_leaves

    cfg, scfg = chip_smoke.system_config()
    cam = chip_smoke.make_camera(scfg, dev)
    windows = tuple(chip_smoke.bench_window(cfg.backend, cam, dev, seed=s) for s in (0, 1))
    tickets = torch.zeros((2, 1), dtype=torch.int32, device=dev)

    def step(carry, xs):
        def one(s):
            with schur.use_ticket(tickets[s]):
                res = window_ba.optimize(cfg.backend, cam, carry[s])
            return res.state, res.cost
        outs = control.branches(one, range(2))
        return tuple(st for st, _ in outs), torch.stack([c for _, c in outs]) + xs[0]

    zero = torch.zeros((), device=dev)
    want = [window_ba.optimize(cfg.backend, cam, w) for w in windows]
    cap = control.CapturedStep(step, tuple(windows), (zero,), name="two windows", branches=2)
    launches = schur.schur_step_kernel.launches
    cap.replay()
    torch.cuda.synchronize()
    assert schur.schur_step_kernel.launches == launches          # nothing outside the graph
    for w, st in zip(want, cap.carry):
        for a, b in zip(tree_leaves(w.state), tree_leaves(st)):
            assert torch.equal(a, b)
    assert torch.equal(cap.ys, torch.stack([w.cost for w in want]))
    assert {x["branch"] for x in cap.sites} == {0, 1}
    assert not bool(tickets.any())


def test_captured_step_keeps_what_it_closes_over(dev):
    """A tensor only the step's function holds (a constant made with it)
    lives as long as the graph: fresh allocations of its size, filled with
    other values after the capture, do not reach a replay."""
    from flvis_tpu_torch.utils import control

    def make_step():
        const = torch.full((1024,), 3.0, device=dev)

        def step(carry, xs):
            return (carry[0] + const,), xs[0] * 2
        return step

    cap = control.CapturedStep(make_step(), (torch.zeros(1024, device=dev),),
                               (torch.ones((), device=dev),), name="closure")
    junk = [torch.full((1024,), -7.0, device=dev) for _ in range(64)]
    cap.replay()
    torch.cuda.synchronize()
    assert torch.equal(cap.carry[0], torch.full((1024,), 3.0, device=dev)) and len(junk) == 64


def _banded_graph(dev, K=1024, n=1000, n_succ=5, loop_pad=8, seed=0):
    """A drifted ring shaped like loop_closing._build_graph's output: the
    n_succ·K band edges first, then 8 loop edges with true relative poses
    (tests/test_pose_graph.py:_reference_style_graph at K nodes)."""
    from flvis_tpu_torch.geometry import se3, so3
    from flvis_tpu_torch.loop import pose_graph

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n)
    ts = np.zeros((K, 3), np.float32)
    ts[:n] = 20.0 * np.stack([np.cos(th), np.sin(th), 0 * th], -1)
    f = dict(dtype=torch.float32, device=dev)
    gt = se3.SE3(so3.identity((K,), device=dev), torch.as_tensor(ts, **f))
    a = torch.arange(K, device=dev)
    ei, ej = [], []
    for s in range(1, n_succ + 1):
        ei.append(a)
        ej.append(torch.clamp(a + s, max=K - 1))
    loops = [(int(i), int(i) + int(g)) for i, g in
             zip(rng.integers(0, n // 2, loop_pad), rng.integers(n // 3, n // 2, loop_pad))]
    ei.append(torch.as_tensor([i for i, _ in loops], device=dev))
    ej.append(torch.as_tensor([j for _, j in loops], device=dev))
    ei, ej = torch.cat(ei), torch.cat(ej)
    rel = se3.compose(se3.inverse(se3.SE3(gt.q[ei], gt.t[ei])), se3.SE3(gt.q[ej], gt.t[ej]))
    valid = torch.cat([(a + s < n) for s in range(1, n_succ + 1)]
                      + [torch.ones(loop_pad, dtype=torch.bool, device=dev)])
    w = torch.cat([torch.full((K,), 1.0 / s, **f) for s in range(1, n_succ + 1)]
                  + [torch.full((loop_pad,), 5.0, **f)])
    noisy = ts + rng.normal(0, 0.08, ts.shape).astype(np.float32) * (np.arange(K) < n)[:, None]
    g = pose_graph.PoseGraph(node_q=gt.q, node_t=torch.as_tensor(noisy, **f),
                             node_valid=a < n, edge_i=ei, edge_j=ej, edge_q=rel.q,
                             edge_t=rel.t, edge_valid=valid, edge_weight=w)
    return g, ts, n_succ * K


def test_banded_pgo_repeats_bit_for_bit(dev):
    """optimize_banded at 1,024 nodes with 8 loop edges gives the same bits
    twice (fixed-order assembly of D, U, b and U_w; no float atomics), and
    solves the graph: its edges are exact, so the optimum is the truth
    moved by the held node 0's noise (the gauge it fixes), reached within
    1 mm from nodes up to 0.3 m off."""
    from flvis_tpu_torch.loop import pose_graph

    g, ts, band_edges = _banded_graph(dev)
    fixed = torch.zeros(1024, dtype=torch.bool, device=dev)
    fixed[0] = True
    a, ca = pose_graph.optimize_banded(g, fixed, band_edges=band_edges, iters=20)
    b, cb = pose_graph.optimize_banded(g, fixed, band_edges=band_edges, iters=20)
    torch.cuda.synchronize()
    assert torch.equal(a.node_q, b.node_q) and torch.equal(a.node_t, b.node_t)
    assert torch.equal(ca, cb) and bool(torch.isfinite(a.node_t).all())
    gauge = g.node_t[0].cpu().numpy() - ts[0]
    err0 = np.linalg.norm(g.node_t[:1000].cpu().numpy() - ts[:1000], axis=-1).max()
    err1 = np.linalg.norm(a.node_t[:1000].cpu().numpy() - ts[:1000] - gauge, axis=-1).max()
    assert err0 > 0.2 and err1 < 1e-3, (err1, err0)


def _entry_rgbd_frames(n=12):
    """n RGB-D frames of the entry scene's out-and-back pan: the uint8
    image, a float32 Z16 depth image (mm) and the IMU packets."""
    from flvis_tpu_torch.io.synthetic import PlanarScene, SceneConfig

    imgs0, _, ts, imu = _entry_frames(n, blank=())
    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                       baseline=0.12)
    xs = list(np.linspace(0, 0.3, n // 2)) + list(np.linspace(0.3, 0.02, n - n // 2))
    scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
    depth = np.stack([np.round(1000.0 * scene.render(np.eye(3), -np.asarray([x, 0.0, 0.0]))[2])
                      for x in xs]).astype(np.float32)
    return imgs0, depth, ts, imu


def _rgbd_system(dev, **kw):
    from flvis_tpu_torch.geometry import camera
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    cfg, _ = _entry_system(dev, depth_mode=True)
    cam = camera.make(200.0, 200.0, 128.0, 96.0, 0.0, depth_factor=1000.0, width=256,
                      height=192, device=dev)
    return SlamSystem(cfg, cam, device=dev, seed=0, **kw)


@pytest.mark.parametrize("kind", ["stereo", "vio"])
def test_rgbd_captured_step_matches_eager(dev, kind):
    """SlamSystem in depth mode (a float32 depth image as the second input):
    the captured step, picked by its inputs' dtypes, against the eager
    composition on the same draws, bit for bit."""
    frames = _entry_rgbd_frames()
    slam = _rgbd_system(dev, use_imu=kind == "vio")
    got = _chunks(slam, kind, frames, 6)
    want, costs = _eager_chunks(_rgbd_system(dev, use_imu=kind == "vio"), kind, frames, 6)
    _assert_same_outputs(got, want)
    assert slam.ba_costs == costs and len(costs) >= 2
    assert np.all(np.concatenate([o.status for o in got])[1:] == 1)
    (key,) = slam._captured
    assert key[0] == kind and key[2] == torch.float32
    with pytest.raises(TypeError, match="captured for torch.float32 inputs"):
        slam._captured[key].run(None, (torch.zeros((1, 192, 256), dtype=torch.uint8,
                                                   device=dev),) * 2, None)


def test_depth_system_never_launches_sweep(dev):
    """A depth-mode SlamSystem with the loop node ingests its keyframes
    through ORB (fastblur) and the depth image: sweep never launches."""
    from flvis_tpu_torch.ops.kernels import fastblur, sweep

    imgs0, depth, ts, imu = _entry_rgbd_frames()
    slam = _rgbd_system(dev, use_loop=True)
    s0, f0 = sweep.sweep_maps_kernel.launches, fastblur.fast_score_nms_blur_kernel.launches
    for a in range(0, 12, 6):
        slam.process_frames(imgs0[a:a + 6], depth[a:a + 6], ts[a:a + 6])
    slam.flush_loop()
    torch.cuda.synchronize()
    assert slam.loop_closer.count == len(slam.keyframes) >= 2
    assert fastblur.fast_score_nms_blur_kernel.launches - f0 >= slam.loop_closer.count
    assert sweep.sweep_maps_kernel.launches == s0


def test_dead_captured_system_is_not_collected_mid_capture(dev, monkeypatch):
    """A captured SlamSystem dropped by its caller lives on in a reference
    cycle (its step's function closes over it) until the collector frees
    it, which releases its graph and memory pool: the next capture collects
    such cycles before it starts and keeps the collector off while it
    captures (a release mid-capture aborted the card tests' process)."""
    import gc
    import weakref

    from flvis_tpu_torch.frontend import tracker
    from flvis_tpu_torch.pipeline.runner import SlamSystem
    from flvis_tpu_torch.utils import control

    cfg, cam = _entry_system(dev)
    imgs0, imgs1, ts, _ = _entry_frames(n=4, blank=())
    a = SlamSystem(cfg, cam, device=dev, seed=0)
    a.process_frames(imgs0, imgs1, ts)
    dead = weakref.ref(next(iter(a._captured.values())).step)
    del a
    assert dead() is not None                         # held by its cycle
    seen = []
    real = tracker.track_frame

    def track(*args, **kw):
        if control._MODE.capture is not None:
            seen.append(gc.isenabled())
        return real(*args, **kw)

    monkeypatch.setattr(tracker, "track_frame", track)
    assert gc.isenabled()
    b = SlamSystem(cfg, cam, device=dev, seed=0)
    out = b.process_frames(imgs0, imgs1, ts)
    torch.cuda.synchronize()
    assert seen == [False] and gc.isenabled()
    assert dead() is None
    assert np.all(out.status[1:] == 1)
