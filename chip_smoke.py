"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from flvis_tpu_torch/csrc/, holds each
kernel against its plain PyTorch version at the shapes the main paths give
it (and times each kernel — its device time from torch.profiler and its
wrapper's time between CUDA events — its plain version and, where one
PyTorch call computes the same function, that call), then drives three
paths of the port at the EuRoC-sized bench configuration:

  a. the stereo slice — SlamSystem.process_frames (tracker + keyframe
     window BA + correction feedback) over a rendered 64-frame sequence;
  b. the headline composition — SlamSystem(use_imu=True, use_loop=True)
    .process_frames_vio over the bench's 256-frame out-and-back loop-event
     sequence with trajectory-consistent IMU, at the default LoopConfig
     widths (1000 ORB features, 4096 words, 2048 keyframe slots), the loop
     node resolving one chunk late as in the reference's chunked replay;
  c. the multi-sequence composition — MultiSeqSlam(num_seqs=8,
     use_imu=True, use_loop=True, ba_every=2, pipelined=True) over 8 chunks
     of 8 frames of a 64-frame out-and-back per sequence.

Each path runs with every kernel's launch count set to 0 just before it and
read just after; the run fails unless every frame tracked, the trajectory
error is in bound, the loop paths closed loops, and each kernel of each
path launched on it.  Exits non-zero, printing no result, if there is no
CUDA device or any phase fails.  The second-to-last lines hold the kernel
table (JSON) and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

import collections
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
MS_SEQS, MS_CHUNK, MS_CHUNKS = 8, 8, 8    # phase c: 8 sequences × 8 chunks of 8 frames
# The __global__ functions of each kernel's source, for its device time.
KERNEL_FNS = {"grad_blur": ("grad_blur_kernel",),
              "schur_step": ("schur_reduce_solve", "schur_backsub"),
              "imu_chain": ("attitude_chain_kernel",), "fastblur": ("fastblur_kernel",),
              "sweep": ("sweep_kernel",), "hamming": ("hamming_kernel",),
              "bowassign": ("bowassign_kernel",), "gather": ("gather_kernel",)}
# Card peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores.  Integer XOR/popcount work is
# counted at the float32 rate (the data sheet lists no int32 CUDA-core rate).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(*fns, reps: int = 50, warmup: int = 10):
    """Median milliseconds of each fn() between CUDA events, the fns timed
    in turns (the first of each round rotating), so that drift in the
    host's speed over the measurement falls on all of them alike; the first
    `warmup` rounds are not kept."""
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(-warmup, reps):
        for i in range(len(fns)):
            k = (i + r) % len(fns)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fns[k]()
            e1.record()
            e1.synchronize()
            if r >= 0:
                times[k].append(e0.elapsed_time(e1))
    return [statistics.median(t) for t in times]


def profile_kernels(fn, name: str, reps: int = 20):
    """torch.profiler over reps calls of fn() → (the median device ms of
    each __global__ of KERNEL_FNS[name], each launched once a call; the
    device kernels one call launches, of any name).  The tracer drops
    kernel events now and then, some profiles whole: a profile in which
    any __global__ of KERNEL_FNS[name] shows fewer than reps / 2 events is
    taken again, up to 5 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_fn = {k: [] for k in KERNEL_FNS[name]}
        names = collections.Counter()
        for e in p.events():
            if e.device_type == DeviceType.CUDA:
                names[e.name] += 1
                for k, v in by_fn.items():
                    if k in e.name:
                        v.append(e.time_range.elapsed_us())
        if all(len(v) >= reps // 2 for v in by_fn.values()):
            break
        print(f"{name}: kernel events {({k: len(v) for k, v in by_fn.items()})} in the profile "
              f"of {reps} calls (attempt {attempt + 1} of 5)")
    else:
        fail(f"{name}: no profile of {reps} calls held all its kernels' events")
    split = {k: statistics.median(v) / 1000.0 for k, v in by_fn.items()}
    if len(split) > 1:
        print(f"{name} device ms per call by __global__: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    # A lost event can only lower the count, a kernel seen at all raises it.
    per_call = max(len(names), -(-sum(names.values()) // reps))
    return split, per_call


def device_ms(fn, name: str) -> float:
    """Device milliseconds per call of fn()'s own kernels, summed over the
    __global__ functions of KERNEL_FNS[name] (profile_kernels)."""
    return sum(profile_kernels(fn, name)[0].values())


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


def entry(name, source, replaces, err, dev_ms, event_ms, plain_ms, library_ms, nbytes, ops):
    """A row of the kernel table: `ms` is the kernel's device time
    (torch.profiler), `event_ms` its wrapper's time between CUDA events."""
    b_ms, b_by = bound(nbytes, ops)
    print(f"  {name}: device {dev_ms:.4f} ms, CUDA events {event_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by})")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": dev_ms, "event_ms": event_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


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
    err_max, dev, ms, plain_ms, lib_ms, nbytes, ops = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
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
        k_ms, p_ms, l_ms = cuda_ms(lambda: gradpyr.grad_blur_kernel(x),
                                   lambda: gradpyr.grad_blur_plain(x),
                                   lambda: F.conv2d(xp, wts))
        dev += device_ms(lambda: gradpyr.grad_blur_kernel(x), "grad_blur")
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
                 "flvis_tpu/ops/pallas/gradpyr.py:82", err_max, dev, ms, plain_ms, lib_ms,
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
    k_ms, p_ms = cuda_ms(lambda: schur.schur_step_kernel(*args, delta),
                         lambda: schur.schur_step_plain(*args, delta))
    W, L = st.obs_valid.shape
    split, per_step = profile_kernels(lambda: schur.schur_step_kernel(*args, delta),
                                      "schur_step")
    print(f"schur_step: {per_step} device kernels per LM step")
    if per_step > 2:
        fail(f"schur_step takes {per_step} launches per LM step, more than 2")
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
                 "flvis_tpu/ops/pallas/schur.py:305", max(errs.values()), sum(split.values()),
                 k_ms, p_ms, None, nbytes, ops)


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
    k_ms, p_ms = cuda_ms(lambda: imu_chain.attitude_chain_kernel(q0, G, a, c),
                         lambda: imu_chain.attitude_chain_plain(q0, G, a, c))
    print(f"attitude_chain (P={P}): max_abs_err {err:.3e} (tol {IMU_TOL}), "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    if not err <= IMU_TOL:
        fail(f"attitude_chain kernel disagrees with its plain version: {err}")
    nbytes = 4.0 * (4 + P * (4 + 3 + 1) + P * 4)
    return entry("imu_chain", "flvis_tpu_torch/csrc/imu_chain.cu",
                 "flvis_tpu/ops/pallas/imu_chain.py:104", err,
                 device_ms(lambda: imu_chain.attitude_chain_kernel(q0, G, a, c), "imu_chain"),
                 k_ms, p_ms, None, nbytes, 90.0 * P)


def check_fastblur(img):
    from flvis_tpu_torch.ops.kernels import fastblur

    s_k, b_k = fastblur.fast_score_nms_blur_kernel(img)
    s_p, b_p = fastblur.fast_score_nms_blur_plain(img)
    torch.cuda.synchronize()
    err = max(float((s_k - s_p).abs().max()), float((b_k - b_p).abs().max()))
    n_k, n_p = int((s_k > 0).sum()), int((s_p > 0).sum())
    k_ms, p_ms = cuda_ms(lambda: fastblur.fast_score_nms_blur_kernel(img),
                         lambda: fastblur.fast_score_nms_blur_plain(img))
    print(f"fast_score_nms_blur {tuple(img.shape)}: max_abs_err {err:.3e} (tol {FAST_TOL}), "
          f"corners {n_k} / {n_p}, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    if not err <= FAST_TOL or n_k != n_p:
        fail(f"fast_score_nms_blur kernel disagrees with its plain version: {err}, "
             f"{n_k} vs {n_p} corners")
    # One image in, two maps out; ~150 flops per pixel (16 ring differences,
    # the arc tests, 3x3 max, the 14 blur taps).
    return entry("fastblur", "flvis_tpu_torch/csrc/fastblur.cu",
                 "flvis_tpu/ops/pallas/fastblur.py:138", err,
                 device_ms(lambda: fastblur.fast_score_nms_blur_kernel(img), "fastblur"), k_ms,
                 p_ms, None,
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
    k_ms, p_ms = cuda_ms(lambda: sweep.sweep_maps_kernel(L, R),
                         lambda: sweep.sweep_maps_plain(L, R))
    print(f"sweep_maps {tuple(L.shape)}: disparity max_abs_err {err:.3e} (tol {SWEEP_TOL}) "
          f"over {int(both.sum())} ok pixels, ok masks differ on {share:.2e} "
          f"(tol {SWEEP_OK_SHARE}), kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    if not (err <= SWEEP_TOL and share <= SWEEP_OK_SHARE):
        fail(f"sweep_maps kernel disagrees with its plain version: {err}, {share}")
    # Two half-res images in, disparity + cost + ok out; per pixel and
    # disparity a difference, an abs and 8 box adds, plus the 64-way reductions.
    n = L.numel()
    return entry("sweep", "flvis_tpu_torch/csrc/sweep.cu",
                 "flvis_tpu/ops/pallas/sweep.py:111", err,
                 device_ms(lambda: sweep.sweep_maps_kernel(L, R), "sweep"), k_ms, p_ms, None,
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
    k_ms, p_ms, l_ms = cuda_ms(lambda: hamming.hamming_matrix_kernel(desc_a, desc_b),
                               lambda: hamming.hamming_matrix_plain(desc_a, desc_b),
                               lambda: torch.matmul(pa, pb.T))
    na, nb = desc_a.shape[0], desc_b.shape[0]
    print(f"hamming_matrix ({na}x{nb}): max_abs_err {err} (exact), kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, ±1 matmul {l_ms:.4f} ms (its error {lib_err})")
    if err != 0:
        fail(f"hamming_matrix kernel disagrees with its plain version: {err}")
    return entry("hamming", "flvis_tpu_torch/csrc/hamming.cu",
                 "flvis_tpu/ops/pallas/hamming.py:56", err,
                 device_ms(lambda: hamming.hamming_matrix_kernel(desc_a, desc_b), "hamming"),
                 k_ms, p_ms, l_ms,
                 32.0 * (na + nb) + 4.0 * na * nb, 24.0 * na * nb)


def check_bowassign(descs, valids, cfg):
    """Term frequencies of B keyframes' descriptors against a vocabulary
    trained on them (bow.train at the LoopConfig width)."""
    from flvis_tpu_torch.loop import bow
    from flvis_tpu_torch.ops import orb
    from flvis_tpu_torch.ops.kernels import bowassign

    desc, valid = torch.stack(descs).contiguous(), torch.stack(valids).contiguous()
    B, N = valid.shape
    vocab = bow.train(desc[valid], torch.ones(int(valid.sum()), dtype=torch.bool,
                                              device=desc.device),
                      num_words=cfg.loop.vocab_words, iters=6)
    words = vocab.words_packed
    V = words.shape[0]
    got = bowassign.bow_tf_kernel(desc, valid, words)
    ref = bowassign.bow_tf_plain(desc, valid, words, vocab.words_pm1)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    # The ±1 product + argmax over all B·N descriptors at once, unpacked
    # outside the timing: the library yardstick (histogram not included).
    d_pm1 = orb.unpack_pm1(desc.reshape(-1, 8))
    lib = torch.argmax(d_pm1 @ vocab.words_pm1.T, dim=1)
    lib_tf = torch.zeros((B, V), dtype=torch.int32, device=desc.device).index_put_(
        (torch.arange(B * N, device=desc.device) // N, lib), valid.reshape(-1).to(torch.int32),
        accumulate=True)
    lib_err = int((lib_tf - ref).abs().max())
    k_ms, p_ms, l_ms = cuda_ms(
        lambda: bowassign.bow_tf_kernel(desc, valid, words),
        lambda: bowassign.bow_tf_plain(desc, valid, words, vocab.words_pm1),
        lambda: torch.argmax(d_pm1 @ vocab.words_pm1.T, dim=1))
    print(f"bow_tf (B={B}, N={N}, V={V}, {int(valid.sum())} valid): max_abs_err {err} (exact), "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, ±1 matmul + argmax {l_ms:.4f} ms "
          f"(its tf error {lib_err})")
    if err != 0:
        fail(f"bow_tf kernel disagrees with its plain version: {err}")
    # Operations: an XOR and a popcount per word pair and descriptor, plus the
    # running-minimum compare; bytes: descriptors, validity, words in, tf out.
    ops = float(B * N) * V * (8 * 2 + 1)
    nbytes = 33.0 * B * N + 32.0 * V + 4.0 * B * V
    return entry("bowassign", "flvis_tpu_torch/csrc/bowassign.cu",
                 "flvis_tpu/ops/pallas/bowassign.py:84", err,
                 device_ms(lambda: bowassign.bow_tf_kernel(desc, valid, words), "bowassign"),
                 k_ms, p_ms, l_ms, nbytes, ops)


def covered_pixels(h, w, ccx, ccy, size, pad):
    """Distinct pixels of an (h, w) image that (size, size) windows at the
    clamped padded-image corners (ccx, ccy) read through the edge border."""
    ar = torch.arange(size, device=ccx.device)
    rows = torch.clamp(ccy[:, None] - pad + ar, 0, h - 1)
    cols = torch.clamp(ccx[:, None] - pad + ar, 0, w - 1)
    mask = torch.zeros((h, w), dtype=torch.bool, device=ccx.device)
    mask[rows[:, :, None], cols[:, None, :]] = True
    return int(mask.sum())


def check_gather(img, cfg, device):
    """Windows mode at the block gathers of one LK level-0 step (256
    template blocks of the (img, gx, gy) planes, 256 search windows) and one
    ORB patch gather (1000 keypoints), at their corner clamps; patches mode
    at the LK template patches (256 points, radius 10, three planes)."""
    from flvis_tpu_torch.ops.kernels import gather

    rng = np.random.default_rng(3)
    H, W = img.shape
    fcfg = cfg.frontend
    r, m = fcfg.lk_radius, 8                        # LKParams.search_margin
    wd = 2 * r + 1 + 2 * m + 2
    planes = (img, (img * 0.5).contiguous(), (img * 0.25).contiguous())
    cases = [("LK template blocks", planes, 2 * r + 2, r + 2, fcfg.num_slots),
             ("LK search windows", img, wd, wd, fcfg.num_slots),
             ("ORB patches", img, 27, 14, cfg.loop.num_orb_features)]
    err, dev, k_ms, p_ms, l_ms, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    for label, x, size, pad, n in cases:
        cx = torch.as_tensor(rng.integers(0, W + 2 * pad - size + 3, n), device=device)
        cy = torch.as_tensor(rng.integers(0, H + 2 * pad - size + 3, n), device=device)
        got = gather.gather_windows_kernel(x, cx, cy, size, pad)
        ref = gather.gather_windows_plain(x, cx, cy, size, pad)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        # The library yardstick: advanced indexing into the padded image,
        # padding and indices made outside the timing.
        ar = torch.arange(size, device=device)
        ccx = torch.clamp(cx, 0, W + 2 * pad - size)
        ccy = torch.clamp(cy, 0, H + 2 * pad - size)
        rows, cols = (ccy[:, None] + ar)[:, :, None], (ccx[:, None] + ar)[:, None, :]
        x3 = torch.stack(x) if isinstance(x, tuple) else x[None]
        padded = torch.nn.functional.pad(x3[None], (pad,) * 4, mode="replicate")[0]

        def lib():
            return padded[:, rows, cols]

        lib_err = float((lib().permute(1, 0, 2, 3).reshape(ref.shape) - ref).abs().max())
        km, pm, lm = cuda_ms(lambda: gather.gather_windows_kernel(x, cx, cy, size, pad),
                             lambda: gather.gather_windows_plain(x, cx, cy, size, pad), lib)
        dm = device_ms(lambda: gather.gather_windows_kernel(x, cx, cy, size, pad), "gather")
        print(f"gather_windows {label} {tuple(x3.shape)} s={size} pad={pad} N={n}: "
              f"max_abs_err {e} (exact), device {dm:.4f} ms, kernel {km:.4f} ms, plain "
              f"{pm:.4f} ms, indexing {lm:.4f} ms (its error {lib_err})")
        if e != 0:
            fail(f"gather_windows kernel disagrees with its plain version ({label}): {e}")
        err, dev, k_ms, p_ms, l_ms = max(err, e), dev + dm, k_ms + km, p_ms + pm, l_ms + lm
        # Bytes: the output written once, the distinct pixels the clamped
        # windows cover read once per plane, the corners read once.
        nbytes += (4.0 * got.numel() + 4.0 * x3.shape[0] * covered_pixels(H, W, ccx, ccy, size, pad)
                   + 16.0 * n)
    # Patches mode: centres over the image and off its edges.
    n = fcfg.num_slots
    cen = torch.as_tensor(rng.uniform([-4.0, -4.0], [W + 4.0, H + 4.0], (n, 2)),
                          dtype=torch.float32, device=device)
    got = gather.gather_patches_kernel(planes, cen, r)
    ref = gather.gather_patches_plain(planes, cen, r)
    torch.cuda.synchronize()
    pe = float((got - ref).abs().max())
    pkm, ppm = cuda_ms(lambda: gather.gather_patches_kernel(planes, cen, r),
                       lambda: gather.gather_patches_plain(planes, cen, r))
    pdm = device_ms(lambda: gather.gather_patches_kernel(planes, cen, r), "gather")
    print(f"gather_patches LK template patches 3 x {tuple(img.shape)} r={r} N={n}: max_abs_err "
          f"{pe} (exact), device {pdm:.4f} ms, kernel {pkm:.4f} ms, plain {ppm:.4f} ms")
    if pe != 0:
        fail(f"gather_patches kernel disagrees with its plain version: {pe}")
    row = entry("gather", "flvis_tpu_torch/csrc/gather.cu", "flvis_tpu/ops/pallas/gather.py:89",
                max(err, pe), dev, k_ms, p_ms, l_ms, nbytes, 0.0)
    row.update(patches_ms=pdm, patches_event_ms=pkm, patches_plain_ms=ppm)
    return row


def kernels():
    from flvis_tpu_torch.ops.kernels import (bowassign, fastblur, gather, gradpyr, hamming,
                                             imu_chain, schur, sweep)

    return {"grad_blur": gradpyr.grad_blur_kernel, "schur_step": schur.schur_step_kernel,
            "imu_chain": imu_chain.attitude_chain_kernel,
            "fastblur": fastblur.fast_score_nms_blur_kernel,
            "sweep": sweep.sweep_maps_kernel, "hamming": hamming.hamming_matrix_kernel,
            "bowassign": bowassign.bow_tf_kernel, "gather": gather.gather_windows_kernel}


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


NESTED = ("verification",)              # timed inside "loop gate decisions + verify" too


def wrap_loop_node(timer, lc):
    """Time the chunked loop node's stages of one LoopCloser."""
    timer.wrap(lc, "add_keyframes_batch", "loop ingest")
    timer.wrap(lc, "gate_candidates", "loop gate")
    timer.wrap(lc, "dispatch_verify", "loop gate decisions + verify")
    timer.wrap(lc, "_verify_device", "verification")
    timer.wrap(lc, "resolve_verify", "loop accept")
    timer.wrap(lc, "optimize_graph", "pgo")


def wrap_frame_stages(timer):
    """Time the frame step's stages (module functions, wrapped where every
    caller finds them)."""
    from flvis_tpu_torch.pipeline import runner

    for mod, name in ((runner.vimotion, "imu_feed_batch"), (runner.vimotion, "get_frame_state"),
                      (runner.tracker, "apply_correction"), (runner.tracker, "track_frame"),
                      (runner.vimotion, "rp_compensate_pose"), (runner.tracker, "rebase_pose"),
                      (runner.vimotion, "correction_from_vision"),
                      (runner.tracker, "make_keyframe_packet"), (runner.window_ba, "add_keyframe"),
                      (runner.window_ba, "optimize")):
        timer.wrap(mod, name, f"{mod.__name__.rsplit('.', 1)[1]}.{name}")


def run_headline(cfg, scfg, cam, device):
    """SlamSystem(use_imu=True, use_loop=True).process_frames_vio over the
    loop-event sequence, the loop node resolving one chunk late, then
    flush_loop; returns the launch counts of the run."""
    from flvis_tpu_torch.geometry import se3
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    poses, imgs0, imgs1, frame_t, accs, gyros, imuts, path = loop_sequence(scfg)
    slam = SlamSystem(cfg, cam, device=device, seed=0, T_i_c=se3.identity(device=device),
                      use_imu=True, use_loop=True)
    lc = slam.loop_closer
    timer = StageTimer()
    wrap_frame_stages(timer)
    wrap_loop_node(timer, lc)
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
    tc = time.perf_counter()
    slam.flush_loop()                   # the last chunks' gate and verification
    torch.cuda.synchronize()
    plain_s += time.perf_counter() - tc
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
    staged = sum(v for k, v in timer.ms.items() if k not in NESTED)
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


def out_and_back(n: int, far: float):
    """x positions of an out-and-back along x (0 → far → 0.01), as the
    bench's loop-event sequence (bench.py:368-372), and the path length."""
    half = n // 2
    xs = np.concatenate([np.linspace(0.0, far, half), np.linspace(far, 0.01, n - half)])
    return xs, float(np.sum(np.abs(np.diff(xs))))


def closure_errors(lc, C_gt):
    """Per accepted closure (i, j, inliers): the translation error of its
    measured T_ij and of the odometry's relative pose between the same two
    keyframes, each against the ground truth (the scene's camera never
    rotates, so the true T_ij is (I, C_j - C_i))."""
    from flvis_tpu_torch.geometry import so3

    out = []
    for c in lc.closures:
        fi, fj = int(lc.kf_frame_id[c.kf_i]), int(lc.kf_frame_id[c.kf_j])
        gt = C_gt[fj] - C_gt[fi]
        R_i = so3.to_matrix(lc.kf_q_odom[c.kf_i]).cpu().numpy()
        odo = R_i.T @ (lc.kf_t_odom[c.kf_j] - lc.kf_t_odom[c.kf_i]).cpu().numpy()
        out.append((c.kf_i, c.kf_j, float(np.linalg.norm(c.T_ij.t.cpu().numpy() - gt)),
                    float(np.linalg.norm(odo - gt))))
    return out


def run_multiseq(cfg, scfg, cam, device):
    """MultiSeqSlam(num_seqs=8, use_imu=True, use_loop=True, ba_every=2,
    pipelined=True) over 8 chunks of 8 frames: each sequence a 64-frame
    out-and-back (0 → 0.6 m → back, plane at 8 m) with its IMU; sequences
    2..7 rolled horizontally by 7·s px (bench.py:411-418), sequences 0 and 1
    the same frames (every sequence draws from the same seed).  Returns the
    launch counts of the run."""
    import dataclasses

    from flvis_tpu_torch.io.synthetic import PlanarScene, imu_from_trajectory
    from flvis_tpu_torch.parallel.multiseq_loop import MultiSeqSlam
    from flvis_tpu_torch.pipeline.runner import pack_imu_frames

    S, T, n = MS_SEQS, MS_CHUNK, MS_CHUNK * MS_CHUNKS
    xs, path = out_and_back(n, 0.6)
    poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
    frames = [scene.render(R, t) for (R, t) in poses]
    shift = [0, 0] + [7 * s for s in range(2, S)]
    imgs0 = np.stack([np.roll(np.stack([u8(f[0]) for f in frames]), shift[s], axis=2)
                      for s in range(S)])
    imgs1 = np.stack([np.roll(np.stack([u8(f[1]) for f in frames]), shift[s], axis=2)
                      for s in range(S)])
    t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
    accs, gyros, imuts, prev = [], [], [], -np.inf
    for ft in frame_t:
        m = (t_imu > prev) & (t_imu <= ft)
        accs.append(acc[m]); gyros.append(gyro[m]); imuts.append(t_imu[m])
        prev = ft

    def bc(a):
        return np.broadcast_to(np.asarray(a), (S,) + np.shape(a))

    imu = [tuple(bc(a) for a in pack_imu_frames(accs[c:c + T], gyros[c:c + T],
                                                imuts[c:c + T], 16)) for c in range(0, n, T)]
    ts = bc(np.asarray(frame_t, np.float32))
    # 64 frames hold ~20 keyframes: the loop gate starts at keyframe 10 and
    # searches 8 behind (tests/test_multiseq_loop.py:44-48), not 50/50.
    mcfg = cfg.replace(loop=dataclasses.replace(cfg.loop, kf_start=10, kf_dist=8))
    ms = MultiSeqSlam(mcfg, cam, num_seqs=S, use_imu=True, use_loop=True, ba_every=2,
                      pipelined=True, device=device)
    timer = StageTimer()
    wrap_frame_stages(timer)
    for lc in ms.loopers:
        wrap_loop_node(timer, lc)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rets = []
    for k, c in enumerate(range(0, n, T)):
        rets.append(ms.process_chunk_vio(imgs0[:, c:c + T], imgs1[:, c:c + T], ts[:, c:c + T],
                                         *imu[k]))
    rets.append(ms.flush())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    timer.restore()

    outs = [r for r in rets if r is not None]
    status = np.concatenate([o[:, :, 2] for o in outs], axis=1).astype(np.int32)
    C_gt = np.asarray([-R.T @ t for (R, t) in poses])
    bound_m = 0.02 * path + 0.01
    ates = [ate(ms.trajectory_cam_centers(s), C_gt) for s in range(S)]
    ates_cor = [ate(ms.trajectory_cam_centers(s, loop_corrected=True), C_gt) for s in range(S)]
    pairs = [[(c.kf_i, c.kf_j) for c in lc.closures] for lc in ms.loopers]
    staged = sum(v for k, v in timer.ms.items() if k not in NESTED)
    print(f"multi-sequence: {S} sequences x {n} frames in {len(outs)} chunks of {T}, "
          f"{S * n / wall:.2f} sequence-frames/s ({wall:.1f} s), keyframes "
          f"{[lc.count for lc in ms.loopers]}, closures {[len(p) for p in pairs]}")
    print(f"multi-sequence ATE per sequence (bound {bound_m:.5f} over a {path:.2f} m path): "
          f"odometry {[round(a, 5) for a in ates]}, loop-corrected "
          f"{[round(a, 5) for a in ates_cor]}; sequence 0 closures {pairs[0][:6]}...")
    print("multi-sequence stages, synced host ms in all (per call x calls): "
          + ", ".join(f"{k} {timer.ms[k]:.0f} ({timer.ms[k] / timer.calls[k]:.2f} "
                      f"x{timer.calls[k]})" for k in timer.ms)
          + f"; outside these stages {1000.0 * wall - staged:.0f}")
    print(f"multi-sequence launches: {launches}")
    for s, lc in enumerate(ms.loopers):
        errs = closure_errors(lc, C_gt)
        if not errs:
            continue                    # fails below: every sequence must close
        worst = max(errs, key=lambda e: e[2])
        print(f"multi-sequence closures of sequence {s}: |T_map_odom.t| "
              f"{float(torch.linalg.vector_norm(lc.T_map_odom.t)):.5f} m; translation error "
              f"against the ground truth, loop edges mean "
              f"{np.mean([e[2] for e in errs]):.5f} / max {worst[2]:.5f} m (pair "
              f"{worst[:2]}), odometry between the same keyframes mean "
              f"{np.mean([e[3] for e in errs]):.5f} / max {max(e[3] for e in errs):.5f} m; "
              f"pairs {[e[:2] for e in errs]}")
    if status.shape != (S, n) or not np.all(status[:, 1:] == 1):
        fail(f"multi-sequence frames not TRACKING: {np.argwhere(status[:, 1:] != 1).tolist()}")
    if not all(a < bound_m and b < bound_m for a, b in zip(ates, ates_cor)):
        fail(f"multi-sequence ATE {ates} / loop-corrected {ates_cor} over bound {bound_m}")
    if not all(pairs):
        fail(f"a sequence accepted no loop closure: {[len(p) for p in pairs]}")
    same = all(np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
               for a, b in zip(ms.trajectories[0], ms.trajectories[1]))
    if not (same and pairs[0] == pairs[1]):
        fail("sequences 0 and 1 (same frames, same draws) differ")
    for name in ("bowassign", "gather"):
        if launches[name] < 1:
            fail(f"{name} never launched on the multi-sequence path")
    return launches


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
    # Eight keyframes' descriptors along an out-and-back: the BoW transform's batch.
    scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
    kf_desc, kf_valid = [], []
    for x in out_and_back(16, 0.6)[0][::2]:
        img = torch.as_tensor(u8(scene.render(np.eye(3), -np.asarray([x, 0.0, 0.0]))[0]),
                              device=device).float().contiguous()
        _, d, v, _ = orb.detect_and_compute(img, num_features=cfg.loop.num_orb_features)
        kf_desc.append(d)
        kf_valid.append(v)
    table = [check_grad_blur(device), check_schur(cfg, cam, device), check_imu_chain(device),
             check_fastblur(img_l), check_sweep(img_l, img_r),
             check_hamming(desc_l.contiguous(), desc_r.contiguous()),
             check_bowassign(kf_desc, kf_valid, cfg), check_gather(img_l, cfg, device)]
    print(f"phase kernel checks: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    slice_launches = run_slice(cfg, scfg, cam, device)
    print(f"phase a, stereo slice: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    head_launches, _ = run_headline(cfg, scfg, cam, device)
    print(f"phase b, headline: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_launches = run_multiseq(cfg, scfg, cam, device)
    print(f"phase c, multi-sequence: {time.perf_counter() - t0:.1f} s")

    # Launches on the path each kernel belongs to: the slice for rows 1-2,
    # the headline for 3-6, the multi-sequence composition for 7-8.
    for e in table:
        path_counts = {"grad_blur": slice_launches, "schur_step": slice_launches,
                       "bowassign": ms_launches, "gather": ms_launches}.get(e["name"],
                                                                            head_launches)
        e["launches"] = path_counts[e["name"]]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
