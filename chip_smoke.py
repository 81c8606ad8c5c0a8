"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from flvis_tpu_torch/csrc/, holds each
kernel against its plain PyTorch version at the shapes the main path gives
it (and times both with CUDA events), then drives the main path —
SlamSystem.process_frames (tracker + keyframe window BA + correction
feedback) at the EuRoC-sized bench configuration over a rendered 64-frame
stereo sequence — and checks that every frame tracked, the backend
corrected, the trajectory error is in bound and each kernel launched on
that path.  Exits non-zero, printing no result, if there is no CUDA device
or any phase fails.  The second-to-last lines hold the kernel table (JSON)
and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.
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
N_FRAMES = 64
WARM_FRAMES = 16


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


def system_config():
    from flvis_tpu.config import BackendConfig, FrontendConfig, SystemConfig
    from flvis_tpu.io.synthetic import SceneConfig

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


def check_grad_blur(device):
    from flvis_tpu_torch.ops.kernels import gradpyr

    rng = np.random.default_rng(0)
    err_max, ms, plain_ms = 0.0, 0.0, 0.0
    for (h, w) in [(480, 752), (240, 376), (120, 188)]:
        x = torch.as_tensor(rng.uniform(0, 255, (3, h, w)), dtype=torch.float32,
                            device=device)
        got = gradpyr.grad_blur_kernel(x)
        ref = gradpyr.grad_blur_plain(x)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        k_ms = cuda_ms(lambda: gradpyr.grad_blur_kernel(x))
        p_ms = cuda_ms(lambda: gradpyr.grad_blur_plain(x))
        print(f"grad_blur (3,{h},{w}): max_abs_err {err:.3e} (tol {GRAD_TOL}), "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        if not err <= GRAD_TOL:
            fail(f"grad_blur kernel disagrees with its plain version at ({h},{w}): {err}")
        err_max, ms, plain_ms = max(err_max, err), ms + k_ms, plain_ms + p_ms
    print(f"grad_blur per frame (3 levels): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err_max, ms, plain_ms


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
    return max(errs.values()), k_ms, p_ms


def run_slice(cfg, scfg, cam, device):
    """Drive SlamSystem.process_frames over the rendered sequence; returns
    (system, outputs, ground-truth poses, steady frames/s)."""
    from flvis_tpu.io.synthetic import PlanarScene, orbit_trajectory
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
    poses = orbit_trajectory(N_FRAMES, step=0.02)
    frames = [scene.render(R, t) for (R, t) in poses]

    def u8(a):
        return np.clip(np.round(np.asarray(a)), 0, 255).astype(np.uint8)

    imgs0 = np.stack([u8(f[0]) for f in frames])
    imgs1 = np.stack([u8(f[1]) for f in frames])
    slam = SlamSystem(cfg, cam, device=device, seed=0)
    outs = [slam.process_frames(imgs0[:WARM_FRAMES], imgs1[:WARM_FRAMES])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs.append(slam.process_frames(imgs0[WARM_FRAMES:], imgs1[WARM_FRAMES:]))
    torch.cuda.synchronize()
    fps = (N_FRAMES - WARM_FRAMES) / (time.perf_counter() - t0)
    return slam, outs, poses, fps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from flvis_tpu_torch.backend import window_ba
    from flvis_tpu_torch.ops.kernels import _build, gradpyr, schur

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
    g_err, g_ms, g_plain = check_grad_blur(device)
    s_err, s_ms, s_plain = check_schur(cfg, cam, device)

    gradpyr.grad_blur_kernel.launches = 0
    schur.schur_step_kernel.launches = 0
    slam, outs, poses, fps = run_slice(cfg, scfg, cam, device)
    launches = {"grad_blur": gradpyr.grad_blur_kernel.launches,
                "schur_step": schur.schur_step_kernel.launches}

    status = np.concatenate([o.status for o in outs])
    n_kf = int(np.concatenate([o.is_keyframe for o in outs]).sum())
    C_est = slam.trajectory_cam_centers()
    C_gt = np.asarray([-R.T @ t for (R, t) in poses])
    ate = float(np.sqrt(np.mean(np.sum((C_est - C_gt) ** 2, axis=-1))))
    ate_bound = 0.02 * 0.02 * N_FRAMES + 0.01        # tests/test_tracker.py:97
    print(f"slice: {N_FRAMES} frames, {n_kf} keyframes, statuses {np.bincount(status)}, "
          f"ATE {ate:.5f} m (bound {ate_bound:.5f}), BA costs "
          f"{[round(c, 3) for c in slam.ba_costs[-3:]]}")
    print(f"slice launches: {launches}")

    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        res = window_ba.optimize(cfg.backend, cam, slam.ba_state)
    torch.cuda.synchronize()
    ba_ms = 1000.0 * (time.perf_counter() - t0) / reps
    print(f"steady state: {fps:.2f} frames/s over frames {WARM_FRAMES}..{N_FRAMES - 1}; "
          f"window BA {ba_ms:.2f} ms per keyframe (optimize on the final window, "
          f"cost {float(res.cost):.4f})")

    if not np.all(status[1:] == 1):
        fail(f"frames not TRACKING: {status.tolist()}")
    if not np.isfinite(C_est).all() or C_est.shape != (N_FRAMES, 3):
        fail("trajectory not finite / wrong shape")
    if not ate < ate_bound:
        fail(f"ATE {ate} over bound {ate_bound}")
    n_valid_corr = int(slam.n_valid_corrections)
    if n_valid_corr < 1:
        fail("no valid BA correction")
    if launches["grad_blur"] != 3 * N_FRAMES:
        fail(f"grad_blur launched {launches['grad_blur']} times, expected {3 * N_FRAMES}")
    if launches["schur_step"] < 1:
        fail("schur_step never launched on the main path")
    print(f"valid BA corrections: {n_valid_corr}")

    kernels = [
        {"name": "grad_blur", "route": "cuda", "source": "flvis_tpu_torch/csrc/gradpyr.cu",
         "replaces": "flvis_tpu/ops/pallas/gradpyr.py:82",
         "launches": launches["grad_blur"], "max_abs_err": g_err, "ms": g_ms,
         "plain_ms": g_plain},
        {"name": "schur_step", "route": "cuda", "source": "flvis_tpu_torch/csrc/schur.cu",
         "replaces": "flvis_tpu/ops/pallas/schur.py:305",
         "launches": launches["schur_step"], "max_abs_err": s_err, "ms": s_ms,
         "plain_ms": s_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
