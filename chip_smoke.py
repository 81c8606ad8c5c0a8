"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from flvis_tpu_torch/csrc/, holds each
kernel against its plain PyTorch version at the shapes the main paths give
it (and times kernel, plain version and, where one PyTorch call computes
the same function, that call, with CUDA events), then drives two paths of
the port at the EuRoC-sized bench configuration:

  1. the stereo slice — SlamSystem.process_frames (tracker + keyframe
     window BA + correction feedback) over a rendered 64-frame sequence;
  2. the headline composition — SlamSystem(use_imu=True, use_loop=True)
    .process_frames_vio over the bench's 256-frame out-and-back loop-event
     sequence with trajectory-consistent IMU, at the default LoopConfig
     widths (1000 ORB features, 4096 words, 2048 keyframe slots).

Each path runs with every kernel's launch count set to 0 just before it and
read just after; the run fails unless every frame tracked, the trajectory
error (raw and, for the headline, loop-corrected) is in bound, the headline
closed a loop, and each kernel of each path launched on it.  Exits
non-zero, printing no result, if there is no CUDA device or any phase
fails.  The second-to-last lines hold the kernel table (JSON) and the
card's name and power limit; the last line is {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

GRAD_TOL = 1e-3                       # FMA contraction on [0, 255] inputs
SCHUR_TOL = {"t": 2e-4, "q": 2e-5, "lm": 2e-3}   # tests/test_window_ba.py:201-207
IMU_TOL = 1e-6                        # small-angle series vs exact exp, imu_chain.py:17-21
FAST_TOL = 1e-3                       # sum-order rounding of FAST scores and the blur
SWEEP_TOL = 1e-3                      # disparity where both ok; ok masks may differ on
SWEEP_OK_SHARE = 1e-3                 # at most this share of pixels (argmin near-ties)
N_FRAMES = 64
WARM_FRAMES = 16
LOOP_FRAMES = 256                     # bench.py:368-380, 4 chunks of 64
CHUNK = 64
PROFILE_FRAMES = 8
# Card peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores.  Integer XOR/popcount work is
# counted at the float32 rate (the data sheet lists no int32 CUDA-core rate).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of fn() between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def system_config():
    from flvis_tpu_torch.config import BackendConfig, FrontendConfig, SystemConfig
    from flvis_tpu_torch.io.synthetic import SceneConfig

    fcfg = FrontendConfig(width=752, height=480, num_slots=256, pyramid_levels=3,
                          per_cell=16, min_distance=15.0, margin=20, lk_radius=10,
                          lk_iters=6)
    scfg = SceneConfig(width=752, height=480, fx=458.0, fy=458.0, cx=376.0, cy=240.0,
                       baseline=0.11)
    return SystemConfig(frontend=fcfg, backend=BackendConfig()), scfg


def make_camera(scfg, device):
    from flvis_tpu_torch.geometry import camera

    return camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                       width=scfg.width, height=scfg.height, device=device)


def u8(a):
    return np.clip(np.round(np.asarray(a)), 0, 255).astype(np.uint8)


def bench_window(bcfg, cam, device, n_lm: int = 600, seed: int = 0):
    """A full W-keyframe window over n_lm landmarks with noisy positions,
    built like the reference bench (bench.py:135-154)."""
    from flvis_tpu_torch.backend import window_ba
    from flvis_tpu_torch.geometry import se3, so3

    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform([-4, -3, 4], [4, 3, 14], (n_lm, 3)),
                          dtype=torch.float32, device=device)
    st = window_ba.empty(bcfg, device=device)
    for i in range(bcfg.window_size):
        q = so3.exp(torch.tensor([0.0, 0.002 * i, 0.0], device=device))
        T = se3.SE3(q, -so3.rotate(q, torch.tensor([0.1 * i, 0.0, 0.0], device=device)))
        pc = se3.transform_points(T, pts)
        uvr = torch.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                           cam.fy * pc[:, 1] / pc[:, 2] + cam.cy,
                           cam.fx * (pc[:, 0] - cam.baseline) / pc[:, 2] + cam.cx], -1)
        noise = torch.as_tensor(rng.normal(0.0, 0.05, (n_lm, 3)), dtype=torch.float32,
                                device=device)
        pkt = window_ba.KeyframePacket(
            frame_id=torch.tensor(i, dtype=torch.int32, device=device), q=T.q, t=T.t,
            lm_id=torch.arange(100, 100 + n_lm, dtype=torch.int32, device=device),
            lm_uv=uvr[:, :2], lm_ur=uvr[:, 2],
            lm_ur_mask=torch.ones(n_lm, dtype=torch.bool, device=device),
            lm_pw=pts + noise, lm_mask=torch.ones(n_lm, dtype=torch.bool, device=device))
        st = window_ba.add_keyframe(bcfg, st, pkt)
    return st


def schur_inputs(cam, st, lam: float = 1e-3):
    """The kernel's arguments for the first LM step of optimize() on st."""
    from flvis_tpu_torch.geometry import so3

    W, L = st.obs_valid.shape
    w_mask = st.obs_valid & st.kf_valid[:, None] & st.lm_valid[None, :]
    fid = torch.where(st.kf_valid, st.kf_frame_id, torch.iinfo(torch.int32).max)
    fixed = torch.arange(W, device=fid.device) == torch.argmin(fid)
    urv = st.obs_ur_valid & w_mask
    R = so3.to_matrix(st.kf_q).reshape(W, 9).contiguous()
    obs3 = torch.stack([st.obs_uv[..., 0], st.obs_uv[..., 1], st.obs_ur],
                       dim=1).reshape(3 * W, L).contiguous()
    cam_row = torch.stack([cam.fx, cam.fy, cam.cx, cam.cy, cam.fx * cam.baseline])
    f = torch.float32
    return (R, st.kf_t.contiguous(), st.lm_pw.T.contiguous(), obs3, urv.to(f),
            w_mask.to(f), fixed.to(f), cam_row.to(f),
            torch.tensor(lam, dtype=f, device=fid.device))


def entry(name, source, replaces, err, ms, plain_ms, library_ms, nbytes, ops):
    b_ms, b_by = bound(nbytes, ops)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def check_grad_blur(device):
    import torch.nn.functional as F

    from flvis_tpu_torch.ops import image as imops
    from flvis_tpu_torch.ops.kernels import gradpyr

    rng = np.random.default_rng(0)
    # The three maps as one 5×5 convolution each: the library yardstick,
    # on an input padded outside the timed call.
    k5 = np.outer(imops._PYR_K, imops._PYR_K)
    kx = np.zeros((5, 5), np.float32)
    kx[1:4, 1:4] = np.outer(imops._SCHARR_SMOOTH, imops._DIFF)
    ky = np.zeros((5, 5), np.float32)
    ky[1:4, 1:4] = np.outer(imops._DIFF, imops._SCHARR_SMOOTH)
    wts = torch.as_tensor(np.stack([kx, ky, k5])[:, None], dtype=torch.float32, device=device)
    err_max, ms, plain_ms, lib_ms, nbytes, ops = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    for (h, w) in [(480, 752), (240, 376), (120, 188)]:
        x = torch.as_tensor(rng.uniform(0, 255, (3, h, w)), dtype=torch.float32,
                            device=device)
        got = gradpyr.grad_blur_kernel(x)
        ref = gradpyr.grad_blur_plain(x)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        xp = imops.edge_pad(x, 2)[:, None].contiguous()
        lib = F.conv2d(xp, wts)
        lib_err = max(float((lib[:, i] - ref[i]).abs().max()) for i in range(3))
        k_ms = cuda_ms(lambda: gradpyr.grad_blur_kernel(x))
        p_ms = cuda_ms(lambda: gradpyr.grad_blur_plain(x))
        l_ms = cuda_ms(lambda: F.conv2d(xp, wts))
        print(f"grad_blur (3,{h},{w}): max_abs_err {err:.3e} (tol {GRAD_TOL}), "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, conv2d {l_ms:.4f} ms "
              f"(its error {lib_err:.1e})")
        if not err <= GRAD_TOL:
            fail(f"grad_blur kernel disagrees with its plain version at ({h},{w}): {err}")
        err_max = max(err_max, err)
        ms, plain_ms, lib_ms = ms + k_ms, plain_ms + p_ms, lib_ms + l_ms
        nbytes += 16.0 * x.numel()            # one float in, three out
        ops += 68.0 * x.numel()               # gx 8, gy 11, 5x5 blur 49 flops
    print(f"grad_blur per frame (3 levels): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return entry("grad_blur", "flvis_tpu_torch/csrc/gradpyr.cu",
                 "flvis_tpu/ops/pallas/gradpyr.py:82", err_max, ms, plain_ms, lib_ms,
                 nbytes, ops)


def check_schur(cfg, cam, device):
    from flvis_tpu_torch.geometry import se3
    from flvis_tpu_torch.ops.kernels import schur

    st = bench_window(cfg.backend, cam, device)
    args = schur_inputs(cam, st)
    delta = cfg.backend.huber_delta
    dp_k, dl_k = schur.schur_step_kernel(*args, delta)
    dp_p, dl_p = schur.schur_step_plain(*args, delta)
    dp_k2, dl_k2 = schur.schur_step_kernel(*args, delta)
    torch.cuda.synchronize()
    if not (torch.equal(dp_k, dp_k2) and torch.equal(dl_k, dl_k2)):
        fail("schur_step kernel is not deterministic from run to run")
    poses = st.poses()
    Pk, Pp = se3.retract_left(poses, dp_k), se3.retract_left(poses, dp_p)
    live = st.lm_valid
    errs = {"t": float((Pk.t - Pp.t).abs().max()), "q": float((Pk.q - Pp.q).abs().max()),
            "lm": float((dl_k.T[live] - dl_p.T[live]).abs().max())}
    k_ms = cuda_ms(lambda: schur.schur_step_kernel(*args, delta))
    p_ms = cuda_ms(lambda: schur.schur_step_plain(*args, delta))
    W, L = st.obs_valid.shape
    print(f"schur_step (W={W}, L={L}, {int(live.sum())} live landmarks): errors "
          + ", ".join(f"{k} {v:.3e} (tol {SCHUR_TOL[k]})" for k, v in errs.items())
          + f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    for k, v in errs.items():
        if not v <= SCHUR_TOL[k]:
            fail(f"schur_step kernel disagrees with its plain version: {k} error {v}")
    # Bytes: every input once, dp and dl out.  Operations from this window's
    # data: ~380 flops per live observation (residual, Jacobian, block
    # accumulation), 324 per observing pose pair of a live landmark (its
    # Schur complement term), the 6W dense elimination.
    nbytes = 4.0 * (sum(a.numel() for a in args) + W * 6 + 3 * L)
    wm = args[5]
    n_obs = float(wm.sum())
    per_lm = wm.sum(0)
    ops = 380.0 * n_obs + 324.0 * float((per_lm * per_lm).sum()) + (6 * W) ** 3 * 2 / 3
    return entry("schur_step", "flvis_tpu_torch/csrc/schur.cu",
                 "flvis_tpu/ops/pallas/schur.py:305", max(errs.values()), k_ms, p_ms, None,
                 nbytes, ops)


def check_imu_chain(device):
    from flvis_tpu_torch.geometry import so3
    from flvis_tpu_torch.ops.kernels import imu_chain

    rng = np.random.default_rng(5)
    P = 16                                   # the runner's packet size
    q0 = so3.normalize(torch.as_tensor(rng.normal(0, 1, 4), dtype=torch.float32,
                                       device=device))
    G = so3.exp(torch.as_tensor(rng.normal(0, 0.01, (P, 3)), dtype=torch.float32,
                                device=device)).contiguous()
    a = rng.normal(0, 1, (P, 3))
    a = torch.as_tensor(a / np.linalg.norm(a, axis=1, keepdims=True), dtype=torch.float32,
                        device=device)
    c = torch.as_tensor(rng.uniform(0, 0.025, P), dtype=torch.float32, device=device)
    got = imu_chain.attitude_chain_kernel(q0, G, a, c)
    ref = imu_chain.attitude_chain_plain(q0, G, a, c)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    k_ms = cuda_ms(lambda: imu_chain.attitude_chain_kernel(q0, G, a, c))
    p_ms = cuda_ms(lambda: imu_chain.attitude_chain_plain(q0, G, a, c))
    print(f"attitude_chain (P={P}): max_abs_err {err:.3e} (tol {IMU_TOL}), "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    if not err <= IMU_TOL:
        fail(f"attitude_chain kernel disagrees with its plain version: {err}")
    nbytes = 4.0 * (4 + P * (4 + 3 + 1) + P * 4)
    return entry("imu_chain", "flvis_tpu_torch/csrc/imu_chain.cu",
                 "flvis_tpu/ops/pallas/imu_chain.py:104", err, k_ms, p_ms, None, nbytes,
                 90.0 * P)


def check_fastblur(img):
    from flvis_tpu_torch.ops.kernels import fastblur

    s_k, b_k = fastblur.fast_score_nms_blur_kernel(img)
    s_p, b_p = fastblur.fast_score_nms_blur_plain(img)
    torch.cuda.synchronize()
    err = max(float((s_k - s_p).abs().max()), float((b_k - b_p).abs().max()))
    n_k, n_p = int((s_k > 0).sum()), int((s_p > 0).sum())
    k_ms = cuda_ms(lambda: fastblur.fast_score_nms_blur_kernel(img))
    p_ms = cuda_ms(lambda: fastblur.fast_score_nms_blur_plain(img))
    print(f"fast_score_nms_blur {tuple(img.shape)}: max_abs_err {err:.3e} (tol {FAST_TOL}), "
          f"corners {n_k} / {n_p}, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    if not err <= FAST_TOL or n_k != n_p:
        fail(f"fast_score_nms_blur kernel disagrees with its plain version: {err}, "
             f"{n_k} vs {n_p} corners")
    # One image in, two maps out; ~150 flops per pixel (16 ring differences,
    # the arc tests, 3x3 max, the 14 blur taps).
    return entry("fastblur", "flvis_tpu_torch/csrc/fastblur.cu",
                 "flvis_tpu/ops/pallas/fastblur.py:138", err, k_ms, p_ms, None,
                 12.0 * img.numel(), 150.0 * img.numel())


def check_sweep(img_l, img_r):
    from flvis_tpu_torch.ops.kernels import sweep

    def half(a):
        return a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2).mean(dim=(1, 3)).contiguous()

    L, R = half(img_l), half(img_r)
    d_k, c_k, ok_k = sweep.sweep_maps_kernel(L, R)
    d_p, c_p, ok_p = sweep.sweep_maps_plain(L, R)
    torch.cuda.synchronize()
    both = ok_k & ok_p
    err = float((d_k - d_p)[both].abs().max()) if bool(both.any()) else float("inf")
    share = float((ok_k != ok_p).float().mean())
    k_ms = cuda_ms(lambda: sweep.sweep_maps_kernel(L, R))
    p_ms = cuda_ms(lambda: sweep.sweep_maps_plain(L, R))
    print(f"sweep_maps {tuple(L.shape)}: disparity max_abs_err {err:.3e} (tol {SWEEP_TOL}) "
          f"over {int(both.sum())} ok pixels, ok masks differ on {share:.2e} "
          f"(tol {SWEEP_OK_SHARE}), kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    if not (err <= SWEEP_TOL and share <= SWEEP_OK_SHARE):
        fail(f"sweep_maps kernel disagrees with its plain version: {err}, {share}")
    # Two half-res images in, disparity + cost + ok out; per pixel and
    # disparity a difference, an abs and 8 box adds, plus the 64-way reductions.
    n = L.numel()
    return entry("sweep", "flvis_tpu_torch/csrc/sweep.cu",
                 "flvis_tpu/ops/pallas/sweep.py:111", err, k_ms, p_ms, None,
                 17.0 * n, (64 * 10 + 64 * 4) * float(n))


def check_hamming(desc_a, desc_b):
    from flvis_tpu_torch.ops import orb
    from flvis_tpu_torch.ops.kernels import hamming

    got = hamming.hamming_matrix_kernel(desc_a, desc_b)
    ref = hamming.hamming_matrix_plain(desc_a, desc_b)
    pa, pb = orb.unpack_pm1(desc_a), orb.unpack_pm1(desc_b)
    lib = ((256.0 - torch.matmul(pa, pb.T)) * 0.5).to(torch.int32)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    lib_err = float((lib - ref).abs().max())
    k_ms = cuda_ms(lambda: hamming.hamming_matrix_kernel(desc_a, desc_b))
    p_ms = cuda_ms(lambda: hamming.hamming_matrix_plain(desc_a, desc_b))
    l_ms = cuda_ms(lambda: torch.matmul(pa, pb.T))
    na, nb = desc_a.shape[0], desc_b.shape[0]
    print(f"hamming_matrix ({na}x{nb}): max_abs_err {err} (exact), kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, ±1 matmul {l_ms:.4f} ms (its error {lib_err})")
    if err != 0:
        fail(f"hamming_matrix kernel disagrees with its plain version: {err}")
    return entry("hamming", "flvis_tpu_torch/csrc/hamming.cu",
                 "flvis_tpu/ops/pallas/hamming.py:56", err, k_ms, p_ms, l_ms,
                 32.0 * (na + nb) + 4.0 * na * nb, 24.0 * na * nb)


def kernels():
    from flvis_tpu_torch.ops.kernels import fastblur, gradpyr, hamming, imu_chain, schur, sweep

    return {"grad_blur": gradpyr.grad_blur_kernel, "schur_step": schur.schur_step_kernel,
            "imu_chain": imu_chain.attitude_chain_kernel,
            "fastblur": fastblur.fast_score_nms_blur_kernel,
            "sweep": sweep.sweep_maps_kernel, "hamming": hamming.hamming_matrix_kernel}


def reset_counts():
    for fn in kernels().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernels().items()}


def ate(C_est, C_gt):
    return float(np.sqrt(np.mean(np.sum((C_est - C_gt) ** 2, axis=-1))))


def run_slice(cfg, scfg, cam, device):
    """The stereo slice: SlamSystem.process_frames over a rendered orbit."""
    from flvis_tpu_torch.io.synthetic import PlanarScene, orbit_trajectory
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
    poses = orbit_trajectory(N_FRAMES, step=0.02)
    frames = [scene.render(R, t) for (R, t) in poses]
    imgs0 = np.stack([u8(f[0]) for f in frames])
    imgs1 = np.stack([u8(f[1]) for f in frames])
    slam = SlamSystem(cfg, cam, device=device, seed=0)
    reset_counts()
    outs = [slam.process_frames(imgs0[:WARM_FRAMES], imgs1[:WARM_FRAMES])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs.append(slam.process_frames(imgs0[WARM_FRAMES:], imgs1[WARM_FRAMES:]))
    torch.cuda.synchronize()
    fps = (N_FRAMES - WARM_FRAMES) / (time.perf_counter() - t0)
    launches = read_counts()

    status = np.concatenate([o.status for o in outs])
    n_kf = int(np.concatenate([o.is_keyframe for o in outs]).sum())
    C_est = slam.trajectory_cam_centers()
    err = ate(C_est, np.asarray([-R.T @ t for (R, t) in poses]))
    bound_m = 0.02 * 0.02 * N_FRAMES + 0.01        # tests/test_tracker.py:97
    print(f"slice: {N_FRAMES} frames, {n_kf} keyframes, statuses {np.bincount(status)}, "
          f"ATE {err:.5f} m (bound {bound_m:.5f}), {slam.n_valid_corrections} valid BA "
          f"corrections, {fps:.2f} frames/s over frames {WARM_FRAMES}..{N_FRAMES - 1}")
    print(f"slice launches: {launches}")
    if not np.all(status[1:] == 1):
        fail(f"slice frames not TRACKING: {status.tolist()}")
    if not np.isfinite(C_est).all() or C_est.shape != (N_FRAMES, 3):
        fail("slice trajectory not finite / wrong shape")
    if not err < bound_m:
        fail(f"slice ATE {err} over bound {bound_m}")
    if slam.n_valid_corrections < 1:
        fail("no valid BA correction")
    if launches["grad_blur"] != 3 * N_FRAMES:
        fail(f"grad_blur launched {launches['grad_blur']} times, expected {3 * N_FRAMES}")
    if launches["schur_step"] < 1:
        fail("schur_step never launched on the slice")
    from flvis_tpu_torch.backend import window_ba

    t0 = time.perf_counter()
    for _ in range(5):
        res = window_ba.optimize(cfg.backend, cam, slam.ba_state)
    torch.cuda.synchronize()
    print(f"window BA {1000.0 * (time.perf_counter() - t0) / 5:.2f} ms per keyframe "
          f"(optimize on the final window, cost {float(res.cost):.4f})")
    return launches


class StageTimer:
    """Synced host time and call counts of the headline's stages."""

    def __init__(self):
        self.ms, self.calls, self._real = {}, {}, []
        self.on = True          # off: calls pass through untimed

    def wrap(self, obj, name, label):
        real = getattr(obj, name)
        self._real.append((obj, name, real))

        def timed(*a, **kw):
            if not self.on:
                return real(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            self.ms[label] = self.ms.get(label, 0.0) + 1000.0 * (time.perf_counter() - t0)
            self.calls[label] = self.calls.get(label, 0) + 1
            return out

        setattr(obj, name, timed)

    def restore(self):
        for obj, name, real in reversed(self._real):
            setattr(obj, name, real)


def loop_sequence(scfg):
    """The bench's loop-event sequence (bench.py:368-380): 256 frames out
    along x and back, with IMU split per frame."""
    from flvis_tpu_torch.io.synthetic import PlanarScene, imu_from_trajectory

    scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
    half = LOOP_FRAMES // 2
    xs = np.concatenate([np.linspace(0.0, 0.02 * half, half),
                         np.linspace(0.02 * half, 0.01, LOOP_FRAMES - half)])
    poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    frames = [scene.render(R, t) for (R, t) in poses]
    t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
    accs, gyros, imuts = [], [], []
    prev = -np.inf
    for ft in frame_t:
        m = (t_imu > prev) & (t_imu <= ft)
        accs.append(acc[m]); gyros.append(gyro[m]); imuts.append(t_imu[m])
        prev = ft
    path = float(np.sum(np.abs(np.diff(xs))))
    return (poses, np.stack([u8(f[0]) for f in frames]), np.stack([u8(f[1]) for f in frames]),
            frame_t, accs, gyros, imuts, path)


def run_headline(cfg, scfg, cam, device):
    """SlamSystem(use_imu=True, use_loop=True).process_frames_vio over the
    loop-event sequence; returns the launch counts of the run."""
    from flvis_tpu_torch.geometry import se3
    from flvis_tpu_torch.pipeline import runner
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    poses, imgs0, imgs1, frame_t, accs, gyros, imuts, path = loop_sequence(scfg)
    slam = SlamSystem(cfg, cam, device=device, seed=0, T_i_c=se3.identity(device=device),
                      use_imu=True, use_loop=True)
    lc = slam.loop_closer
    timer = StageTimer()
    for mod, name in ((runner.vimotion, "imu_feed_batch"), (runner.vimotion, "get_frame_state"),
                      (runner.tracker, "apply_correction"), (runner.tracker, "track_frame"),
                      (runner.vimotion, "rp_compensate_pose"), (runner.tracker, "rebase_pose"),
                      (runner.vimotion, "correction_from_vision"),
                      (runner.tracker, "make_keyframe_packet"), (runner.window_ba, "add_keyframe"),
                      (runner.window_ba, "optimize")):
        timer.wrap(mod, name, f"{mod.__name__.rsplit('.', 1)[1]}.{name}")
    timer.wrap(lc, "add_keyframe", "loop ingest")
    timer.wrap(lc, "detect_loop", "detect_loop (incl. verification)")
    timer.wrap(lc, "_verify_device", "verification")
    timer.wrap(lc, "optimize_graph", "pgo")
    reset_counts()
    t0 = time.perf_counter()
    outs, plain_s = [], 0.0
    p0 = 2 * CHUNK                      # a profiled window in the revisit leg
    bounds = [0, CHUNK, p0, p0 + PROFILE_FRAMES, 3 * CHUNK, LOOP_FRAMES]
    for a, b in zip(bounds[:-1], bounds[1:]):
        sl = slice(a, b)

        def run():
            tc = time.perf_counter()
            outs.append(slam.process_frames_vio(imgs0[sl], imgs1[sl], ts=frame_t[sl],
                                                imu_acc=accs[sl], imu_gyro=gyros[sl],
                                                imu_t=imuts[sl]))
            torch.cuda.synchronize()
            return time.perf_counter() - tc

        if a != p0:
            plain_s += run()
            continue
        from torch.profiler import ProfilerActivity, profile

        # The profiled window keeps its stage calls out of the stage timer.
        timer.on = False
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            wall = 1000.0 * run()
        timer.on = True
        avg = p.key_averages()
        dev_ms = sum(e.self_device_time_total for e in avg
                     if e.device_type.name == "CUDA") / 1000.0
        n_events = sum(e.count for e in avg if e.device_type.name == "CUDA")
        host = sorted((e for e in avg if e.device_type.name == "CPU"),
                      key=lambda e: -e.self_cpu_time_total)[:8]
        print("headline profile, top host ops (self CPU ms, calls): "
              + ", ".join(f"{e.key} {e.self_cpu_time_total / 1000.0:.1f} x{e.count}"
                          for e in host))
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    timer.restore()
    # Device busy share: profiled device time per frame over the mean time of
    # the unprofiled frames (the profiler itself slows the host).
    n_plain = LOOP_FRAMES - PROFILE_FRAMES
    frame_ms = 1000.0 * plain_s / n_plain
    busy = dev_ms / PROFILE_FRAMES / frame_ms
    print(f"headline profile, frames {p0}..{p0 + PROFILE_FRAMES - 1}: wall {wall:.1f} ms "
          f"with the profiler on, device kernel time {dev_ms:.1f} ms, {n_events} device "
          f"kernel events; unprofiled frames {frame_ms:.1f} ms each -> device busy "
          f"{busy:.3f}")

    status = np.concatenate([o.status for o in outs])
    n_kf = int(np.concatenate([o.is_keyframe for o in outs]).sum())
    C_gt = np.asarray([-R.T @ t for (R, t) in poses])
    C_raw = slam.trajectory_cam_centers()
    C_cor = slam.trajectory_cam_centers(loop_corrected=True)
    ate_raw, ate_cor = ate(C_raw, C_gt), ate(C_cor, C_gt)
    bound_m = 0.02 * path + 0.01                       # tests/test_pipeline.py:434-435
    closures = [(c.kf_i, c.kf_j, c.num_inliers) for c in lc.closures]
    n_imu = np.cumsum([len(t) for t in imuts])
    init_frames = int(np.sum(n_imu[:-1] >= cfg.vio.init_samples))
    n_verify = timer.calls.get("verification", 0)
    print(f"headline: {LOOP_FRAMES} frames, {n_kf} keyframes ({lc.count} in the loop "
          f"store), statuses {np.bincount(status)}, {len(closures)} closures "
          f"{closures[:8]}{'...' if len(closures) > 8 else ''}, {n_verify} verifications")
    print(f"headline ATE: odometry {ate_raw:.5f} m, loop-corrected {ate_cor:.5f} m "
          f"(bound {bound_m:.5f} over a {path:.2f} m path); T_map_odom t "
          f"{lc.T_map_odom.t.cpu().numpy().round(5).tolist()}")
    nested = ("verification",)          # timed inside detect_loop as well
    staged = sum(v for k, v in timer.ms.items() if k not in nested)
    print(f"headline: {n_plain / plain_s:.2f} frames/s over the {n_plain} unprofiled frames "
          f"({plain_s:.1f} s; {wall_s:.1f} s for the whole phase incl. the profiled window)")
    print("headline stages over the unprofiled frames, synced host ms in all (per call x "
          "calls): " + ", ".join(f"{k} {timer.ms[k]:.0f} ({timer.ms[k] / timer.calls[k]:.2f} "
                                 f"x{timer.calls[k]})" for k in timer.ms)
          + f"; outside these stages {1000.0 * plain_s - staged:.0f}")
    print(f"headline launches: {launches} (IMU-initialised frames {init_frames})")
    if not np.all(status[1:] == 1):
        fail(f"headline frames not TRACKING: {np.flatnonzero(status != 1).tolist()}")
    if not (np.isfinite(C_cor).all() and C_cor.shape == (LOOP_FRAMES, 3)):
        fail("headline trajectory not finite / wrong shape")
    if not closures:
        fail("headline run accepted no loop closure")
    if not (ate_raw < bound_m and ate_cor < bound_m):
        fail(f"headline ATE {ate_raw} / {ate_cor} over bound {bound_m}")
    if launches["imu_chain"] < init_frames:
        fail(f"imu_chain launched {launches['imu_chain']} times < {init_frames} frames")
    for name in ("fastblur", "sweep"):
        if launches[name] < n_kf:
            fail(f"{name} launched {launches[name]} times < {n_kf} keyframes")
    if launches["hamming"] < max(n_verify, 1):
        fail(f"hamming launched {launches['hamming']} times < {n_verify} verifications")
    return launches, busy


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from flvis_tpu_torch.ops import orb
    from flvis_tpu_torch.ops.kernels import _build

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"gpu: {smi}")

    t0 = time.perf_counter()
    _, info = _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {info['build_s']:.2f} s) "
          f"-> {info['path']}")
    for line in info["ptxas"].splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    cfg, scfg = system_config()
    cam = make_camera(scfg, device)
    t0 = time.perf_counter()
    from flvis_tpu_torch.io.synthetic import PlanarScene

    img_l, img_r, _ = PlanarScene(scfg, plane_depth=8.0, seed=0).render(np.eye(3), np.zeros(3))
    img_l = torch.as_tensor(u8(img_l), device=device).float().contiguous()
    img_r = torch.as_tensor(u8(img_r), device=device).float().contiguous()
    _, desc_l, _, _ = orb.detect_and_compute(img_l, num_features=cfg.loop.num_orb_features)
    _, desc_r, _, _ = orb.detect_and_compute(img_r, num_features=cfg.loop.num_orb_features)
    table = [check_grad_blur(device), check_schur(cfg, cam, device), check_imu_chain(device),
             check_fastblur(img_l), check_sweep(img_l, img_r),
             check_hamming(desc_l.contiguous(), desc_r.contiguous())]
    print(f"phase kernel checks: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    slice_launches = run_slice(cfg, scfg, cam, device)
    print(f"phase stereo slice: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    head_launches, _ = run_headline(cfg, scfg, cam, device)
    print(f"phase headline: {time.perf_counter() - t0:.1f} s")

    for e in table:
        path_counts = slice_launches if e["name"] in ("grad_blur", "schur_step") \
            else head_launches
        e["launches"] = path_counts[e["name"]]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
