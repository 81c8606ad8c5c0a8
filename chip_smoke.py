"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]
    python3 chip_smoke.py --mma-rates
    python3 chip_smoke.py --phase-c
    python3 chip_smoke.py --phase-de

Builds the port's CUDA kernels from flvis_tpu_torch/csrc/, holds each
kernel against its plain PyTorch version at the shapes the main paths give
it (and times each kernel — its device time from torch.profiler and its
wrapper's time between CUDA events — its plain version and, where one
PyTorch call computes the same function, that call; hamming in both its
modes, the match mode over a bucket of 8 keyframe pairs), then drives three
paths of the port at the EuRoC-sized bench configuration:

  a. the stereo slice — SlamSystem.process_frames (tracker + keyframe
     window BA + correction feedback) over a rendered 64-frame sequence;
  b. the headline composition — SlamSystem(use_imu=True, use_loop=True)
    .process_frames_vio over the bench's 256-frame out-and-back loop-event
     sequence with trajectory-consistent IMU, at the default LoopConfig
     widths (1000 ORB features, 4096 words, 2048 keyframe slots), the loop
     node resolving one chunk late as in the reference's chunked replay;
     (a) and (b) each run twice in turn on the same frames and draws: the
     captured frame step (one CUDA-graph replay a frame, the path a user
     calls) and the eager composition (a Python loop over
     runner._fused_*_step); both print frames/s, the device busy share,
     host syncs a frame in a chunk's step and device kernel events a frame,
     the captured run also its graph's kernel nodes, IF bodies and WHILE
     iterations run a replay and its capture time, and the run fails unless
     both give the same outputs, BA costs, closures and ATE bit for bit;
     between them, the rare branches (blank frames: FAIL and re-init;
     starved frames: the PnP rescue) run inside the graph against the eager
     composition;
  c. the multi-sequence composition — MultiSeqSlam(num_seqs=8,
     use_imu=True, use_loop=True, ba_every=2, pipelined=True) over 8 chunks
     of 8 frames of a 64-frame out-and-back per sequence, twice in turn as
     (a) and (b): the captured step (one graph a frame, the 8 sequences its
     branches) and the eager loop over the same step; it prints
     sequence-frames/s, the device busy share, host syncs, the graph's
     nodes, IF bodies and WHILE iterations a replay, how far the branches
     overlap (one replay's device time against 8 × a one-branch graph's)
     and the host time of one cudaGraphLaunch, and fails unless both runs
     give the same outputs, closures and ATE bit for bit; replays of its
     graph from one state must give the same bits each time.  Phase c
     runs in a process of its own (`--phase-c`, see phase_c);
  e. RGB-D — SlamSystem with depth_mode (baseline 0, depth_factor 1000, a
     float32 Z16 depth image as the second input) at the same system
     configuration: process_frames over (a)'s 64-frame orbit, and
     process_frames_vio with use_loop=True over (b)'s 256-frame
     out-and-back, each captured and eager on the same frames and draws,
     bit-equal (closures and ATE too); every frame tracks, sweep never
     launches; the trajectory through io/trajectory (TUM, KITTI) read back
     and utils/evaluation.ate_rmse against the run's ATE; and, where cv2
     imports, the synthetic EuRoC-format sequence through io/euroc;
  d. the long run — tests/test_longrun.py's 1,100 keyframes (160×120)
     through the port's LoopCloser in chunks of 32, with its assertions
     (store ≥ 2,048 rows, refreshes past 1,024, ≥ 3 closures, a window
     past 256 keyframes: the banded PGO, drift corrected); PGO ms a call
     by route and n_pad, the last banded PGO twice more bit-equal, host
     syncs per banded LM iteration, banded against dense at K = 64 and the
     cold 2,048-node ring at 20 against 100 iterations.  Phases e and d
     run in a process of their own (`--phase-de`), e's steps captured
     before its first trace.

Each path runs with every kernel's launch count set to 0 just before it and
read just after (a captured step is captured before that, its warm-up's
launches printed on a line of their own).  A replay runs no kernel
wrapper, so the launches of the captured step's kernels (grad_blur,
schur_step, imu_chain, gather) are read from the device: their events in
the profiled chunk's replays, by kernel name.  The run fails unless every
frame tracked, the trajectory error is in bound, the loop paths closed
loops, each kernel of each path launched on it (the captured step's inside
its replays), and PGO on the headline's last pose graph, run twice more,
gives the headline's own bits.  Phases b and c print the loop
node's verification per verified pair (synced ms, device events) and the
accepted closures; with --parent DIR, phases b and c of the port in DIR (a
`git archive` of another commit, each run in a subprocess with this
script's probes) follow, and both trees' readings stand side by side.  Exits
non-zero, printing no result, if there is no CUDA device or any phase
fails.  The second-to-last lines hold the kernel table (JSON) and the
card's name and power limit; the last line is
{"ok": true, "device": {...}}.

With --mma-rates it only reads the issue rate and latency of the warp-level
mma.sync forms a Hamming distance can run on (see mma_rates).
"""

import collections
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

GRAD_TOL = 1e-3                       # FMA contraction on [0, 255] inputs
SCHUR_TOL = {"t": 2e-4, "q": 2e-5, "lm": 2e-3}   # tests/test_window_ba.py:201-207
IMU_TOL = 1e-6                        # small-angle series vs exact exp, imu_chain.py:17-21
IMU_SUM_TOL = 1e-5                    # the fused feed's pos, vel: FMA vs cumsum, float32
FAST_TOL = 1e-3                       # sum-order rounding of FAST scores and the blur
N_FRAMES = 64
WARM_FRAMES = 16
SYNC_FRAMES = 8                       # the chunk whose step's host syncs are counted
LOOP_FRAMES = 256                     # bench.py:368-380, 4 chunks of 64
CHUNK = 64
PROFILE_FRAMES = 8
MS_SEQS, MS_CHUNK, MS_CHUNKS = 8, 8, 8    # phase c: 8 sequences × 8 chunks of 8 frames
# The __global__ functions of each kernel's source, for its device time.
KERNEL_FNS = {"grad_blur": ("grad_blur_kernel",),
              "schur_step": ("schur_reduce_solve", "schur_backsub"),
              "imu_chain": ("attitude_chain_kernel", "imu_feed_kernel"),
              "fastblur": ("fastblur_kernel",),
              "sweep": ("sweep_kernel",),
              "hamming": ("hamming_kernel", "hamming_match_kernel"),
              "bowassign": ("bowassign_kernel",), "gather": ("gather_kernel",)}
# Card peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s,
# float32 operations/s outside the tensor cores, and dense int8 tensor-core
# operations/s.  Integer XOR/popcount work would not run at the float32 rate:
# the CUDA programming guide's throughput table gives compute capability 9.0
# 16 population counts per SM per clock, an eighth of its float32 rate
# (check_hamming prints that pipe's floor beside its row).  The binary
# tensor-core path (mma.sync m16n8k256 .b1, csrc/hamming.cu's) issues at the
# int8 form's m16n8k32 rate with 8x its bits a product (--mma-rates reads
# both), so its peak is 8x the int8 one, a 1-bit multiply-add counted as
# two operations as an int8 one is.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_I8 = 1979e12
PEAK_B1 = 8 * PEAK_I8
POPC_PER_SM_CLOCK = 16
LANES_PER_SM_CLOCK = 128              # 4 schedulers, one warp instruction a clock each
# csrc/fastblur.cu's tile: TY rows by TX columns, NT threads a block.
FAST_TY, FAST_TX, FAST_NT = 11, 126, 128
# The attitude chain's dependent path in cycles, one sample (csrc/imu_chain.cu
# chain_step), counted from the source: 25 dependent float32 multiply/add
# steps at 4 cycles each (q ⊗ G 4, ĝ 3, v 3, θ² 3, the series, its scaling
# and the product 7, |q|² 4, the scaling 1) and one rsqrt on the
# special-function unit (~16 cycles).
CHAIN_DEP_CYCLES = 25 * 4 + 16


SMI = "card not read yet"            # nvidia-smi's name and power limit, set by main()
T_START = time.perf_counter()


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


def profile_events(fn, complete, reps: int = 20, label: str = "kernel"):
    """torch.profiler over reps calls of fn() → {device kernel name: [us of
    each event]}.  The tracer drops kernel events now and then, some
    profiles whole: a profile for which complete(events) is false is taken
    again, up to 5 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = collections.defaultdict(list)
        for e in p.events():
            if e.device_type == DeviceType.CUDA:
                events[e.name].append(e.time_range.elapsed_us())
        if complete(events):
            return events
        print(f"{label}: kernel events {({k: len(v) for k, v in events.items()})} in the profile "
              f"of {reps} calls (attempt {attempt + 1} of 5)")
    fail(f"{label}: no profile of {reps} calls held all its kernels' events")


def profile_kernels(fn, name: str, reps: int = 20, fns=None):
    """torch.profiler over reps calls of fn() → (the median device ms of
    each __global__ of KERNEL_FNS[name] (or of its subset fns), each
    launched once a call; the device kernels one call launches, of any
    name).  A profile in which any of them shows fewer than reps / 2 events
    is taken again (profile_events)."""
    def per_fn(events):
        return {k: [t for n, v in events.items() if k in n for t in v]
                for k in fns or KERNEL_FNS[name]}

    events = profile_events(fn, lambda ev: all(len(v) >= reps // 2 for v in per_fn(ev).values()),
                            reps, name)
    split = {k: statistics.median(v) / 1000.0 for k, v in per_fn(events).items()}
    if len(split) > 1:
        print(f"{name} device ms per call by __global__: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    # A lost event can only lower the count, a kernel seen at all raises it.
    per_call = max(len(events), -(-sum(len(v) for v in events.values()) // reps))
    return split, per_call


def device_ms(fn, name: str, fns=None) -> float:
    """Device milliseconds per call of fn()'s own kernels, summed over the
    __global__ functions of KERNEL_FNS[name] or fns (profile_kernels)."""
    return sum(profile_kernels(fn, name, fns=fns)[0].values())


def sm_clock_mhz() -> float:
    """The SM clock's maximum, MHz, as nvidia-smi reads it."""
    return float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                 "--format=csv,noheader,nounits"], capture_output=True,
                                text=True, check=True).stdout.split()[0])


def bound(nbytes: float, ops: float, peak: float = PEAK_F32):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their peak rate (float32 unless given)."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
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


def z16(depth_m):
    """A depth image in metres as a D435's Z16 image (millimetres, integers),
    float32: the second input of the RGB-D mode (depth_factor 1000)."""
    return np.clip(np.round(1000.0 * np.asarray(depth_m)), 0, 65535).astype(np.float32)


_MEMO = {}
RENDERS = "CHIP_SMOKE_RENDERS"          # the directory main() shares renders in


def once(fn=None, *, shared: bool = False):
    """fn's result, made once per process for each repr of its arguments —
    a path's captured and eager runs take the same rendered frames, and
    rendering them takes longer than running them; `shared`: also once for
    the phases' processes, through files in the directory main() names in
    the environment variable RENDERS (phase e renders (a)'s and (b)'s
    frames)."""
    if fn is None:
        return functools.partial(once, shared=shared)

    @functools.wraps(fn)
    def run(*a):
        key = (fn.__name__, repr(a))
        if key not in _MEMO:
            _MEMO[key] = stored(key, lambda: fn(*a)) if shared else fn(*a)
        return _MEMO[key]

    return run


def stored(key, make):
    """make()'s result through a pickle file named by `key` in the RENDERS
    directory (made and read by this script only): loaded if another
    process of the run wrote it, else made and written."""
    import hashlib
    import os
    import pickle

    d = os.environ.get(RENDERS)
    if not d:
        return make()
    path = Path(d) / f"{key[0]}-{hashlib.sha1(key[1].encode()).hexdigest()[:16]}.pkl"
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    out = make()
    tmp = path.with_suffix(".part")
    with open(tmp, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)
    return out


@once(shared=True)
def orbit_frames(scfg):
    """(a)'s 64-frame orbit: its poses, uint8 left and right images and Z16
    depth images."""
    from flvis_tpu_torch.io.synthetic import PlanarScene, orbit_trajectory

    scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
    poses = orbit_trajectory(N_FRAMES, step=0.02)
    frames = [scene.render(R, t) for (R, t) in poses]
    return (poses, np.stack([u8(f[0]) for f in frames]), np.stack([u8(f[1]) for f in frames]),
            np.stack([z16(f[2]) for f in frames]))


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


def entry(name, source, replaces, err, dev_ms, event_ms, plain_ms, library_ms, nbytes, ops,
          peak: float = PEAK_F32):
    """A row of the kernel table: `ms` is the kernel's device time
    (torch.profiler), `event_ms` its wrapper's time between CUDA events."""
    b_ms, b_by = bound(nbytes, ops, peak)
    print(f"  {name}: device {dev_ms:.4f} ms, CUDA events {event_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by})")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": dev_ms, "event_ms": event_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


PYR_SHAPES = ((480, 752), (240, 376), (120, 188))   # the 3 levels at 480x752
# The pyramid's own bytes per pixel by level: 4 in, gx and gy out, and the
# quarter-size next image (1 B/px) on every level but the last.
PYR_BYTES_PER_PX = (13.0, 13.0, 12.0)


def profile_by_name(fn, reps: int = 20):
    """{device kernel name: (mean ms per launch, launches per call)} over
    reps calls of fn(), every device kernel of the calls, of any name.  The
    tracer can lose a profile's first event (a kernel launched outside
    PyTorch, alone in its call, lost one of its 20 in every profile of one
    run), so launches per call are rounded, exact while fewer than reps / 2
    of a name's events are lost; a profile with no event is taken again.
    The mean, not the median: one name may cover launches of different
    sizes in a call (a pyramid's levels), and mean x launches is their sum."""
    events = profile_events(fn, bool, reps, "profile")
    return {k: (statistics.fmean(v) / 1000.0, round(len(v) / reps)) for k, v in events.items()}


def pyramid_readings(device):
    """Device time of one frame's pyramid, build_grad_pyramid at (3, 480,
    752) over 3 levels, every kernel it launches counted; and each level's
    grad_blur in its full mode.  Uses only what every version of the port
    has, so it reads a parent tree the same way.  Returns (pyramid ms per
    frame, {kernel name: (ms, launches per frame)})."""
    from flvis_tpu_torch.ops import image as imops
    from flvis_tpu_torch.ops.kernels import gradpyr

    rng = np.random.default_rng(0)
    for (h, w) in PYR_SHAPES:
        x = torch.as_tensor(rng.uniform(0, 255, (3, h, w)), dtype=torch.float32, device=device)
        print(f"grad_blur full mode (3,{h},{w}): device "
              f"{device_ms(lambda: gradpyr.grad_blur_kernel(x), 'grad_blur'):.4f} ms")
    x0 = torch.as_tensor(rng.uniform(0, 255, (3,) + PYR_SHAPES[0]), dtype=torch.float32,
                         device=device)
    kern = profile_by_name(lambda: imops.build_grad_pyramid(x0, len(PYR_SHAPES)))
    total = sum(ms * n for ms, n in kern.values())
    print(f"pyramid per frame (3,{PYR_SHAPES[0][0]},{PYR_SHAPES[0][1]}), "
          f"{len(PYR_SHAPES)} levels: device {total:.4f} ms in "
          f"{sum(n for _, n in kern.values())} launches: "
          + "; ".join(f"{k[:60]} {ms:.4f} ms x{n}" for k, (ms, n) in kern.items()))
    return total, kern


def check_grad_blur(device):
    """Each pyramid level in all three modes against the plain version; the
    row times each level in the mode build_grad_pyramid gives it (next,
    next, none) and bounds it by the pyramid's own bytes."""
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
    for lvl, (h, w) in enumerate(PYR_SHAPES):
        mode = "next" if lvl + 1 < len(PYR_SHAPES) else "none"
        x = torch.as_tensor(rng.uniform(0, 255, (3, h, w)), dtype=torch.float32,
                            device=device)
        errs = {}
        for m in gradpyr.MODES:
            got = gradpyr.grad_blur_kernel(x, m)
            ref = gradpyr.grad_blur_plain(x, m)
            torch.cuda.synchronize()
            if (got[2] is None) != (ref[2] is None) or any(
                    a.shape != b.shape for a, b in zip(got, ref) if b is not None):
                fail(f"grad_blur {m} mode returns other shapes than its plain version")
            errs[m] = max(float((a - b).abs().max()) for a, b in zip(got, ref) if b is not None)
        err = max(errs.values())
        xp = imops.edge_pad(x, 2)[:, None].contiguous()
        full = gradpyr.grad_blur_plain(x)
        lib = F.conv2d(xp, wts)
        lib_err = max(float((lib[:, i] - full[i]).abs().max()) for i in range(3))
        k_ms, p_ms, l_ms = cuda_ms(lambda: gradpyr.grad_blur_kernel(x, mode),
                                   lambda: gradpyr.grad_blur_plain(x, mode),
                                   lambda: F.conv2d(xp, wts))
        d_ms = device_ms(lambda: gradpyr.grad_blur_kernel(x, mode), "grad_blur")
        lvl_bytes = PYR_BYTES_PER_PX[lvl] * x.numel()
        print(f"grad_blur level {lvl} (3,{h},{w}) {mode} mode: max_abs_err "
              + ", ".join(f"{m} {e:.3e}" for m, e in errs.items())
              + f" (tol {GRAD_TOL}); device {d_ms:.4f} ms (bound {bound(lvl_bytes, 0.0)[0]:.5f}"
              f" ms), kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, conv2d {l_ms:.4f} ms "
              f"(its error {lib_err:.1e})")
        if not err <= GRAD_TOL:
            fail(f"grad_blur kernel disagrees with its plain version at ({h},{w}): {errs}")
        err_max = max(err_max, err)
        dev, ms, plain_ms, lib_ms = dev + d_ms, ms + k_ms, plain_ms + p_ms, lib_ms + l_ms
        nbytes += lvl_bytes
        # gx 8 and gy 11 flops a pixel; the 5x5 blur's 49 at the even pixels.
        ops += (19.0 + (49.0 / 4 if mode == "next" else 0.0)) * x.numel()
    total, kern = pyramid_readings(device)
    if sum(n for _, n in kern.values()) != len(PYR_SHAPES) or not all(
            "grad_blur_kernel" in k for k in kern):
        fail(f"the pyramid launches other kernels than one grad_blur per level: {kern}")
    print(f"grad_blur per frame (3 levels): device {dev:.4f} ms (pyramid {total:.4f} ms), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
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


def imu_packets(device, P: int = 16, n: int = 32, seed: int = 5):
    """VioConfig() and n runner-sized IMU packets (acc, gyro, t, valid) on
    the card from a seed, 200 Hz, gravity plus noise and a turning motion:
    the first initialises the filter; the second, one row masked, completes
    initialisation mid-packet; then steady packets, some suffix-padded as
    runner.pack_imu_frames pads them (11 valid, none valid); 32 × 16 samples
    wrap the 400-slot ring."""
    from flvis_tpu_torch.config import VioConfig

    rng = np.random.default_rng(seed)
    packets = []
    for k in range(n):
        t = 0.005 * (P * k + np.arange(1, P + 1))
        acc = np.array([0.3, -0.2, 9.78]) + rng.normal(0.0, 0.05, (P, 3))
        gyro = rng.normal(0.0, 0.002, (P, 3)) + [0.004, -0.003, 0.002]
        if k >= 2:
            acc += rng.normal([0.4, -0.2, -0.2], 0.3, (P, 3))
            gyro += rng.normal(0.03, 0.15, (P, 3)) + [0.0, 0.0, 0.5]
        valid = np.ones(P, bool)
        if k == 1:
            valid[3 % P] = False
        elif k % 7 == 5:
            valid[11:] = False
        elif k == 20:
            valid[:] = False
        t[~valid], acc[~valid], gyro[~valid] = 0.0, 0.0, 0.0
        packets.append(tuple(torch.as_tensor(x, dtype=dt, device=device) for x, dt in
                             ((acc, torch.float32), (gyro, torch.float32), (t, torch.float32),
                              (valid, torch.bool))))
    return VioConfig(), packets


def check_imu_chain(device):
    """The fused feed (one launch a packet, the path's kernel) against
    imu_feed_batch_plain over imu_packets, each packet from the same state
    (the kernel's previous one), and the chain-only entry (the
    TPU kernel's own function) against attitude_chain_plain; the row is the
    fused kernel's, in steady mode, with init mode and the chain beside."""
    from flvis_tpu_torch.geometry import so3
    from flvis_tpu_torch.ops.kernels import imu_chain
    from flvis_tpu_torch.vio import vimotion

    cfg, packets = imu_packets(device)
    P, C = packets[0][2].shape[0], cfg.imu_capacity
    sk = init = vimotion.init_state(cfg, device=device)
    errs = {"q": 0.0, "sums": 0.0, "exact": 0}
    for pk in packets:
        new = vimotion.imu_feed_batch(cfg, sk, *pk)
        ref = vimotion.imu_feed_batch_plain(cfg, sk, *pk)
        sk = new
        for k in imu_chain.FEED_FIELDS:
            a, b = getattr(new, k), getattr(ref, k)
            if k == "q":
                errs["q"] = max(errs["q"], float((a - b).abs().max()))
            elif k in ("pos", "vel"):
                errs["sums"] = max(errs["sums"], float((a - b).abs().max()))
            elif not torch.equal(a, b):
                errs["exact"] += 1
    steady = packets[-1]
    feed = (lambda: vimotion.imu_feed_batch(cfg, sk, *steady),
            lambda: vimotion.imu_feed_batch_plain(cfg, sk, *steady))
    print(f"imu_feed (P={P}, C={C}, {len(packets)} packets: init, mid-packet switch, steady, "
          f"padded, ring wrap): q max_abs_err {errs['q']:.3e} (tol {IMU_TOL}), pos/vel "
          f"{errs['sums']:.3e} (tol {IMU_SUM_TOL}), {errs['exact']} exact-field mismatches")
    if not (errs["q"] <= IMU_TOL and errs["sums"] <= IMU_SUM_TOL and errs["exact"] == 0
            and bool(sk.initialized)):
        fail(f"imu_feed kernel disagrees with its plain version: {errs}")

    rng = np.random.default_rng(5)
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
    if not err <= IMU_TOL:
        fail(f"attitude_chain kernel disagrees with its plain version: {err}")
    k_ms, p_ms, ck_ms, cp_ms = cuda_ms(
        *feed, lambda: imu_chain.attitude_chain_kernel(q0, G, a, c),
        lambda: imu_chain.attitude_chain_plain(q0, G, a, c))
    fused = ("imu_feed_kernel",)
    dev_init = device_ms(lambda: vimotion.imu_feed_batch(cfg, init, *packets[0]), "imu_chain",
                         fused)
    dev_chain = device_ms(lambda: imu_chain.attitude_chain_kernel(q0, G, a, c), "imu_chain",
                          ("attitude_chain_kernel",))
    print(f"attitude_chain (P={P}): max_abs_err {err:.3e} (tol {IMU_TOL}), device "
          f"{dev_chain:.4f} ms, kernel {ck_ms:.4f} ms, plain {cp_ms:.4f} ms; imu_feed "
          f"init mode: device {dev_init:.4f} ms a packet")
    # Where the fused kernel's steady time goes: packets of 1, P and 2P
    # samples on the same state; the slope is a sample's share, the
    # intercept what a launch costs whatever the packet.
    by_p = {}
    for p in (1, P, 2 * P):
        pk = imu_packets(device, P=p, n=3)[1][-1]
        by_p[p] = device_ms(lambda: vimotion.imu_feed_batch(cfg, sk, *pk), "imu_chain", fused)
    slope = (by_p[2 * P] - by_p[1]) / (2 * P - 1)
    print("imu_feed steady device ms by packet size: "
          + ", ".join(f"P={p} {ms:.4f}" for p, ms in by_p.items())
          + f"; {slope * 1e3:.4f} us a sample, {by_p[1] - slope:.4f} ms a launch")
    # Bytes: the packet in (acc, gyro, t, valid), the ring (17 floats a slot)
    # read and written, the scalars (biases, init sums, head, count, flag,
    # init count) in and out.  Operations: ~200 a sample (the chain, the
    # exps, the trust weight, the rotation, the sums).
    nbytes = P * 29.0 + 2 * 68.0 * C + 2 * 61.0
    row = entry("imu_chain", "flvis_tpu_torch/csrc/imu_chain.cu",
                "flvis_tpu/ops/pallas/imu_chain.py:104", max(err, errs["q"]),
                device_ms(feed[0], "imu_chain", fused), k_ms, p_ms, None, nbytes, 200.0 * P)
    row.update(init_ms=dev_init, chain_ms=dev_chain, chain_event_ms=ck_ms, chain_plain_ms=cp_ms)
    # A diagnostic beside the bound: the chain's serial latency, P dependent
    # steps of CHAIN_DEP_CYCLES at the SM clock nvidia-smi reads.
    mhz = sm_clock_mhz()
    print(f"  imu_chain: serial-latency floor {P * CHAIN_DEP_CYCLES / mhz / 1e3:.6f} ms "
          f"({P} x {CHAIN_DEP_CYCLES} dependent cycles at {mhz:.0f} MHz, clocks.max.sm)")
    return row


def sass_instructions(fn_name: str) -> int:
    """Instructions of the __global__ fn_name in the built library's SASS
    (cuobjdump -sass), NOPs not counted."""
    import re

    from flvis_tpu_torch.ops.kernels import _build

    _, info = _build.load_library()
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", info["path"]], capture_output=True, text=True,
                          check=True).stdout
    body = [b for b in sass.split("Function : ")[1:] if fn_name in b.split("\n", 1)[0]]
    if len(body) != 1:
        fail(f"cuobjdump: {len(body)} functions named like {fn_name}")
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body[0])
    return sum(op != "NOP" for op in ops)


def check_fastblur(img):
    from flvis_tpu_torch.ops.kernels import fastblur

    s_k, b_k = fastblur.fast_score_nms_blur_kernel(img)
    s_p, b_p = fastblur.fast_score_nms_blur_plain(img)
    torch.cuda.synchronize()
    err = max(float((s_k - s_p).abs().max()), float((b_k - b_p).abs().max()))
    n_k, n_p = int((s_k > 0).sum()), int((s_p > 0).sum())
    same = torch.equal(s_k > 0, s_p > 0)
    k_ms, p_ms = cuda_ms(lambda: fastblur.fast_score_nms_blur_kernel(img),
                         lambda: fastblur.fast_score_nms_blur_plain(img))
    print(f"fast_score_nms_blur {tuple(img.shape)}: max_abs_err {err:.3e} (tol {FAST_TOL}), "
          f"corners {n_k} / {n_p}, {'the same' if same else 'DIFFERENT'} corner set, "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    if not err <= FAST_TOL or not same:
        fail(f"fast_score_nms_blur kernel disagrees with its plain version: {err}, "
             f"{n_k} vs {n_p} corners")
    # One image in, two maps out; ~150 flops per pixel (16 ring differences,
    # the arc tests, 3x3 max, the 14 blur taps).
    row = entry("fastblur", "flvis_tpu_torch/csrc/fastblur.cu",
                "flvis_tpu/ops/pallas/fastblur.py:138", err,
                device_ms(lambda: fastblur.fast_score_nms_blur_kernel(img), "fastblur"), k_ms,
                p_ms, None,
                12.0 * img.numel(), 150.0 * img.numel())
    # A diagnostic beside the bound: the instruction-issue floor.  The kernel
    # is straight-line code (every loop unrolled), so its static SASS count is
    # what a thread issues, both sides of its few edge branches counted.
    H, W = img.shape
    n_sass = sass_instructions("fastblur_kernel")
    threads = -(-H // FAST_TY) * -(-W // FAST_TX) * FAST_NT
    mhz = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(img.device).multi_processor_count
    floor = n_sass * threads / (sms * LANES_PER_SM_CLOCK * mhz * 1e6) * 1e3
    print(f"  fastblur: issue floor {floor:.6f} ms ({n_sass} SASS instructions a thread, "
          f"{n_sass * threads / img.numel():.0f} a pixel over {threads} threads; {sms} SMs x "
          f"{LANES_PER_SM_CLOCK} lanes a clock at {mhz:.0f} MHz, clocks.max.sm)")
    return row


def feed_readings(device):
    """imu_feed_batch on a CUDA VioState at the runner's packet (imu_packets:
    a steady packet on the filter they initialise, and the first packet on a
    fresh state), and fastblur at 480x752: device ms per call with every
    kernel the call launches, device events per call, host syncs per call
    and CUDA-event ms.  Uses only what every version of the port has, so it
    reads a parent tree the same way."""
    from flvis_tpu_torch.io.synthetic import PlanarScene
    from flvis_tpu_torch.ops.kernels import fastblur
    from flvis_tpu_torch.vio import vimotion

    cfg, packets = imu_packets(device)
    st = init = vimotion.init_state(cfg, device=device)
    for pk in packets:
        st = vimotion.imu_feed_batch(cfg, st, *pk)
    _, scfg = system_config()
    img = PlanarScene(scfg, plane_depth=8.0, seed=0).render(np.eye(3), np.zeros(3))[0]
    img = torch.as_tensor(u8(img), device=device).float().contiguous()
    out = {}
    # The parent's init-mode call is ~3,400 small launches: 5 calls a profile.
    for label, fn, reps in (
            ("fastblur (480, 752)", lambda: fastblur.fast_score_nms_blur_kernel(img), 20),
            ("imu_feed_batch steady", lambda: vimotion.imu_feed_batch(cfg, st, *packets[-1]), 20),
            ("imu_feed_batch init", lambda: vimotion.imu_feed_batch(cfg, init, *packets[0]), 5)):
        kern = profile_by_name(fn, reps)
        dev = sum(ms * n for ms, n in kern.values())
        events = sum(n for _, n in kern.values())
        syncs = host_syncs(fn)
        ev_ms = cuda_ms(fn)[0]
        out[label] = (dev, events, syncs, ev_ms)
        print(f"reading {label}: device {dev:.4f} ms per call in {events} device events "
              f"({sum(n for k, (_, n) in kern.items() if 'emcpy' in k)} copies), {syncs} host "
              f"syncs, CUDA events {ev_ms:.4f} ms")
    return out


def host_syncs(fn) -> int:
    """Synchronising CUDA operations of one fn() call, as PyTorch's sync
    debug mode warns of them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        fn()
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def check_sweep(img_l, img_r):
    from flvis_tpu_torch.ops.kernels import sweep

    def half(a):
        return a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2).mean(dim=(1, 3)).contiguous()

    L, R = half(img_l), half(img_r)
    got = sweep.sweep_maps_kernel(L, R)
    ref = sweep.sweep_maps_plain(L, R)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max(float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max()))
    k_ms, p_ms = cuda_ms(lambda: sweep.sweep_maps_kernel(L, R),
                         lambda: sweep.sweep_maps_plain(L, R))
    print(f"sweep_maps {tuple(L.shape)}: disparity and cost max_abs_err {err:.3e}, maps "
          f"{'bit-equal' if exact else 'DIFFERENT'} (exact), {int(ref[2].sum())} ok pixels, "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    if not exact:
        fail(f"sweep_maps kernel disagrees with its plain version: {err}, ok masks differ on "
             f"{int((got[2] != ref[2]).sum())} pixels")
    dev = device_ms(lambda: sweep.sweep_maps_kernel(L, R), "sweep")
    # The same images at full resolution: 4x the pixels in 1,440 blocks,
    # over two waves of 5 resident blocks per SM.  A time well under 4x says
    # that latency in the one partial wave at half resolution (<= 3 blocks
    # per SM), not the SMs' throughput, sets the pace there.
    big = device_ms(lambda: sweep.sweep_maps_kernel(img_l, img_r), "sweep")
    print(f"sweep_maps {tuple(img_l.shape)}: device {big:.4f} ms, {big / dev:.2f}x the "
          f"{tuple(L.shape)} time for {img_l.numel() / L.numel():.0f}x the pixels")
    # Two half-res images in, disparity + cost + ok out; per pixel and
    # disparity a difference, an abs and 8 box adds, plus the 64-way reductions.
    n = L.numel()
    row = entry("sweep", "flvis_tpu_torch/csrc/sweep.cu", "flvis_tpu/ops/pallas/sweep.py:111",
                err, dev, k_ms, p_ms, None, 17.0 * n, (64 * 10 + 64 * 4) * float(n))
    row.update(full_res_ms=big)
    return row


def check_hamming(desc_a, desc_b, descs, valids):
    """Matrix mode (the TPU kernel's function) at 1000 x 1000 against its
    plain version and the ±1 matmul; match mode (the path's) over a bucket
    of 8 keyframe pairs (k, 7 - k) of the out-and-back, and over one pair,
    against mutual_ratio_match_plain on the card, every output exact."""
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
    row = entry("hamming", "flvis_tpu_torch/csrc/hamming.cu",
                "flvis_tpu/ops/pallas/hamming.py:56", err,
                device_ms(lambda: hamming.hamming_matrix_kernel(desc_a, desc_b), "hamming",
                          ("hamming_kernel",)),
                k_ms, p_ms, l_ms,
                32.0 * (na + nb) + 4.0 * na * nb, 512.0 * na * nb, PEAK_B1)
    # A diagnostic, not the row's bound: the XOR + popcount form's floor on
    # the popcount pipe, 8 popcounts per pair, at the SM clock nvidia-smi reads.
    mhz = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(desc_a.device).multi_processor_count

    def popc_floor(pairs):
        return 8.0 * pairs / (sms * POPC_PER_SM_CLOCK * mhz * 1e6) * 1e3

    print(f"  hamming: popcount pipe floor {popc_floor(na * nb):.6f} ms (8 x {na} x {nb} "
          f"popcounts, {sms} SMs x {POPC_PER_SM_CLOCK} a clock at {mhz:.0f} MHz, clocks.max.sm)")

    # Match mode: the loop node's bucket, the reference's 0.75 ratio.
    B = len(descs)
    args = (torch.stack(descs).contiguous(), torch.stack(descs[::-1]).contiguous(),
            torch.stack(valids).contiguous(), torch.stack(valids[::-1]).contiguous())
    one = tuple(a[:1].contiguous() for a in args)
    errs, m_err = [], 0
    for x in (args, one):
        m_k = hamming.mutual_ratio_match_kernel(*x)
        m_again = hamming.mutual_ratio_match_kernel(*x)
        m_p = hamming.mutual_ratio_match_plain(*x)
        torch.cuda.synchronize()
        errs += [n for n, a, b, c in zip(("best_ab", "good", "d1", "d2", "best_ba"), m_k, m_p,
                                         m_again)
                 if not (torch.equal(a, b) and torch.equal(a, c))]
        m_err = max([m_err] + [int((a.long() - b.long()).abs().max()) for a, b in zip(m_k, m_p)])
    n_good = int(m_p[1].sum())
    mk_ms, mp_ms = cuda_ms(lambda: hamming.mutual_ratio_match_kernel(*args),
                           lambda: hamming.mutual_ratio_match_plain(*args))
    fns = ("hamming_match_kernel",)
    m_dev = device_ms(lambda: hamming.mutual_ratio_match_kernel(*args), "hamming", fns)
    one_dev = device_ms(lambda: hamming.mutual_ratio_match_kernel(*one), "hamming", fns)
    ma, mb = args[0].shape[1], args[1].shape[1]
    # Bytes: descriptors and validity in; best_ab, good, d1, d2 and best_ba
    # out.  Operations: one 256-bit product a distance, B·Na·Nb·512 at the
    # binary path's rate (the int8 rate's time is printed as a diagnostic).
    m_bytes = B * (33.0 * (ma + mb) + 17.0 * ma + 8.0 * mb)
    m_ops = B * ma * mb * 512.0
    m_bound, m_by = bound(m_bytes, m_ops, PEAK_B1)
    print(f"hamming match mode (B={B}, {ma}x{mb}, {int(args[2].sum())} / {int(args[3].sum())} "
          f"valid, {n_good} good): outputs {'bit-equal' if not errs else errs} to "
          f"mutual_ratio_match_plain and on a repeat, also at B=1 (max_abs_err {m_err}); "
          f"device {m_dev:.4f} ms a bucket (B=1: {one_dev:.4f}), kernel {mk_ms:.4f} ms, plain "
          f"{mp_ms:.4f} ms, bound {m_bound:.6f} ms ({m_by}, binary rate); at the int8 rate "
          f"{m_ops / PEAK_I8 * 1e3:.6f} ms; popcount pipe floor "
          f"{popc_floor(B * ma * mb):.6f} ms")
    if errs or m_err:
        fail(f"hamming match mode disagrees with its plain version: {errs}, {m_err}")
    row.update(match_ms=m_dev, match_one_ms=one_dev, match_event_ms=mk_ms, match_plain_ms=mp_ms,
               match_bound_ms=m_bound, match_bound_by=m_by, match_max_abs_err=m_err)
    return row


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
    words, words_i8 = vocab.words_packed, vocab.words_i8
    V = words.shape[0]
    got = bowassign.bow_tf_kernel(desc, valid, words, words_i8=words_i8)
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
        lambda: bowassign.bow_tf_kernel(desc, valid, words, words_i8=words_i8),
        lambda: bowassign.bow_tf_plain(desc, valid, words, vocab.words_pm1),
        lambda: torch.argmax(d_pm1 @ vocab.words_pm1.T, dim=1))
    print(f"bow_tf (B={B}, N={N}, V={V}, {int(valid.sum())} valid): max_abs_err {err} (exact), "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, ±1 matmul + argmax {l_ms:.4f} ms "
          f"(its tf error {lib_err})")
    if err != 0:
        fail(f"bow_tf kernel disagrees with its plain version: {err}")
    # Beyond the default width: LoopConfig(vocab_words=8192), random words
    # with duplicates (ties) and descriptors on them, some invalid.
    rng = np.random.default_rng(8192)
    w8 = rng.integers(0, 2 ** 32, (8192, 8), dtype=np.uint32)
    w8[5000:5020] = w8[3:23]
    d8 = rng.integers(0, 2 ** 32, (2, 50, 8), dtype=np.uint32)
    d8[:, :10] = w8[None, 3:13]
    d8 = torch.as_tensor(d8.view(np.int32), device=desc.device)
    v8 = torch.as_tensor(rng.uniform(size=(2, 50)) > 0.1, device=desc.device)
    w8 = torch.as_tensor(w8.view(np.int32), device=desc.device)
    e8 = int((bowassign.bow_tf_kernel(d8, v8, w8) - bowassign.bow_tf_plain(d8, v8, w8)).abs().max())
    print(f"bow_tf (B=2, N=50, V=8192, ties): max_abs_err {e8} (exact)")
    if e8 != 0:
        fail(f"bow_tf kernel disagrees with its plain version at V=8192: {e8}")
    # One block's worth of descriptors (64) alone, on one SM with no other
    # SM contending for L2: a diagnostic beside the row's full-width time.
    d1, v1 = desc[:1, :64].contiguous(), valid[:1, :64].contiguous()
    one = device_ms(lambda: bowassign.bow_tf_kernel(d1, v1, words, words_i8=words_i8),
                    "bowassign")
    print(f"bow_tf (1, 64, {V}), one block: device {one:.4f} ms")
    # Operations: the ±1 product on the int8 tensor cores, a multiply and an
    # add per (descriptor, word, entry); bytes: descriptors, validity, the
    # int8 words in, tf out.
    ops = 2.0 * B * N * V * 256
    nbytes = 33.0 * B * N + 256.0 * V + 4.0 * B * V
    return entry("bowassign", "flvis_tpu_torch/csrc/bowassign.cu",
                 "flvis_tpu/ops/pallas/bowassign.py:84", err,
                 device_ms(lambda: bowassign.bow_tf_kernel(desc, valid, words, words_i8=words_i8),
                           "bowassign"),
                 k_ms, p_ms, l_ms, nbytes, ops, PEAK_I8)


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
    """{kernel: its wrappers' launch counters}: hamming counts both modes.
    A tree without the match mode (the parent, read with --parent) counts
    what it has."""
    from flvis_tpu_torch.ops.kernels import (bowassign, fastblur, gather, gradpyr, hamming,
                                             imu_chain, schur, sweep)

    ham = (hamming.hamming_matrix_kernel,) + tuple(
        f for f in (getattr(hamming, "mutual_ratio_match_kernel", None),) if f is not None)
    return {"grad_blur": (gradpyr.grad_blur_kernel,), "schur_step": (schur.schur_step_kernel,),
            "imu_chain": (imu_chain.attitude_chain_kernel,),
            "fastblur": (fastblur.fast_score_nms_blur_kernel,),
            "sweep": (sweep.sweep_maps_kernel,), "hamming": ham,
            "bowassign": (bowassign.bow_tf_kernel,), "gather": (gather.gather_windows_kernel,)}


def reset_counts():
    for fns in kernels().values():
        for fn in fns:
            fn.launches = 0


def read_counts():
    return {name: sum(fn.launches for fn in fns) for name, fns in kernels().items()}


# The kernels a captured frame step launches inside its graph, and the
# __global__ each launch runs once (schur_step's second is its back-substitution).
IN_GRAPH = ("grad_blur", "schur_step", "imu_chain", "gather")
LAUNCH_GLOBALS = {k: v[:1] if k == "schur_step" else v for k, v in KERNEL_FNS.items()}


def replay_launches(names, before) -> dict:
    """{kernel: launches of a captured step's replays in a profiled window}:
    its device events in the window's profile ({device event name: count}),
    less the launches its wrappers counted in the window (`before`:
    read_counts() at its start), which ran outside the graph.  A replay runs
    no wrapper, so this is the only count of a replay's launches."""
    after = read_counts()
    events = {k: sum(n for key, n in names.items() if any(f in key for f in fns))
              for k, fns in LAUNCH_GLOBALS.items()}
    return {k: events[k] - (after[k] - before[k]) for k in events}


def frame_inputs(device, imgs0, imgs1, kind):
    """A SlamSystem step's inputs of one frame of the path's shapes (the
    images' first frame; zeros for an IMU packet)."""
    xs = [torch.as_tensor(imgs0[:1], device=device), torch.as_tensor(imgs1[:1], device=device)]
    if kind == "vio":
        xs += [torch.zeros(1, device=device), torch.zeros((1, 16, 3), device=device),
               torch.zeros((1, 16, 3), device=device), torch.zeros((1, 16), device=device),
               torch.zeros((1, 16), dtype=torch.bool, device=device)]
    return tuple(xs)


def capture_first(slam, kind, label, xs) -> None:
    """Capture slam's `kind` step before its main path (on inputs xs of
    the path's shapes; each chunk copies the state in), and print what the
    capture's eager warm-up launched and its wrappers' calls during the
    capture, on a line of their own: the main path's counts start after
    them.  A tree without a captured step captures nothing."""
    if not hasattr(slam, "_captured_step"):
        return
    reset_counts()
    st = slam._captured_step(kind, xs).step
    torch.cuda.synchronize()
    print(f"{label} capture, before the main path: warm-up {st.seconds['warmup']:.2f} s "
          f"({st.WARMUP} eager steps, both sides of every cond), capture "
          f"{st.seconds['capture']:.2f} s; launches counted by its wrappers (warm-up launches "
          f"and capture calls, not the main path's): {read_counts()}")


def path_launches(counted, replayed, captured: bool) -> dict:
    """A path's launches: its wrappers' counts over the path and, for a
    captured step, its replays' launches in the profiled window
    (replay_launches; the other replays are not traced)."""
    if not captured:
        return dict(counted)
    return {k: counted[k] + (replayed[k] if k in IN_GRAPH else 0) for k in counted}


def launch_line(label, counted, replayed, captured: bool, profiled) -> str:
    if not captured:
        return f"{label} launches: {counted}"
    return (f"{label} launches counted by the kernel wrappers over the main path (outside the "
            f"graph): {counted}; launched by the captured step's replays, from the device "
            f"events of the profiled frames {profiled}: { {k: replayed[k] for k in IN_GRAPH} }")


def check_in_graph(label, replayed, names) -> None:
    """Fail unless the captured step's replays launched each of `names` in
    the profiled window."""
    for k in names:
        if replayed[k] < 1:
            fail(f"{label}: the captured step's replays launched no {k} in the profiled frames")


def ate(C_est, C_gt):
    return float(np.sqrt(np.mean(np.sum((C_est - C_gt) ** 2, axis=-1))))


def use_eager_chunks(slam):
    """Step slam's chunks through the eager composition — the Python loop
    over runner._fused_*_step (runner.run_chunk_eager) — instead of its
    captured graph, on the same draws: the reference run a captured run is
    held to."""
    slam._run_chunk = slam._run_chunk_eager


def count_chunk_syncs(slam, call: int, out: dict):
    """Count the host syncs of slam's `call`-th chunk step (its frames from
    inputs to outputs; the chunk end's fetch and loop node come after it)
    into out["syncs"]."""
    real = slam._run_chunk
    calls = [0]

    def run(*a, **kw):
        calls[0] += 1
        if calls[0] != call:
            return real(*a, **kw)
        res = []
        out["syncs"] = host_syncs(lambda: res.append(real(*a, **kw)))
        return res[0]

    slam._run_chunk = run


def trace_events(run):
    """run() under torch.profiler, host and device activities: (wall ms, the
    profile's raw events).  Read raw, the events skip the profiler's Python
    records of each one (key_averages), which took tens of seconds for an
    eager chunk's ~10^5 events and a chunk of (c)'s ~10^6."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        run()
        wall = 1000.0 * (time.perf_counter() - t0)
    return wall, list(p.profiler.kineto_results.events())


def host_self_ms(events) -> dict:
    """{host op name: self ms} of the raw events: each host event's time
    less that of the events nested in it on its thread."""
    from torch.autograd import DeviceType

    threads = collections.defaultdict(list)
    for e in events:
        if e.device_type() == DeviceType.CPU:
            threads[e.start_thread_id()].append((e.start_ns(), -e.end_ns(), e.name()))
    out = collections.Counter()
    for evs in threads.values():
        evs.sort()
        stack = []                      # [start, end, name, children's time]

        def close(until):
            while stack and stack[-1][1] <= until:
                a, b, name, inner = stack.pop()
                out[name] += (b - a - inner) / 1e6
                if stack:
                    stack[-1][3] += b - a

        for a, neg_b, name in evs:
            close(a)
            stack.append([a, -neg_b, name, 0])
        close(float("inf"))
    return dict(out)


def profile_window(run):
    """run() under torch.profiler: (wall ms, device kernel ms, device kernel
    events, {device event name: count}, {host op name: self ms})."""
    wall, events = trace_events(run)
    summed, _, n_events, names = device_spans(events)
    return wall, summed, n_events, names, host_self_ms(events)


def device_spans(events):
    """The device events of a raw profile: (their time summed ms, the union
    of their intervals ms, their number, {name: count})."""
    from torch.autograd import DeviceType

    spans, names = [], collections.Counter()
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            spans.append((e.start_ns(), e.end_ns()))
            names[e.name()] += 1
    spans.sort()
    union, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    summed = sum(b - a for a, b in spans)
    return summed / 1e6, union / 1e6, len(spans), dict(names)


def device_window(run):
    """run() under torch.profiler, its events read raw: (wall ms, device
    event time summed ms, the union of the device events' intervals ms,
    device events, {device event name: count})."""
    wall, events = trace_events(run)
    return (wall,) + device_spans(events)


def graph_report(slam, label) -> dict:
    """Print and return the captured steps' readings: warm-up and capture
    seconds, the graph's nodes, kernel nodes, IF bodies and WHILE iterations
    run a replay, and each site's taken counts (an IF's (true, false), a
    WHILE's (iterations, entries)).  A tree whose node_stats has no WHILE
    count reads 0 there."""
    out = {}
    for key, cap in getattr(slam, "_captured", {}).items():
        kind = key if isinstance(key, str) else key[0]      # a tree keyed by kind alone, or
                                                            # by (kind, input dtypes)
        st = cap.step
        nodes, bodies, iterations = (tuple(st.node_stats()) + (0.0,))[:3]
        taken = st.taken_by_name()
        out[kind] = {"kernel_nodes": nodes, "if_bodies": bodies, "while_iterations": iterations,
                     "taken": taken, "sites": len(st.sites), "replays": st.replays,
                     **st.seconds}
        sites = {}
        for x in st.sites:
            key = (x.get("kind", "if"), x["name"], x["nodes"][0]["kernel"],
                   x["nodes"][1]["kernel"])
            sites[key] = sites.get(key, 0) + 1
        print(f"{label} captured {kind} step: warm-up {st.seconds['warmup']:.2f} s, capture "
              f"{st.seconds['capture']:.2f} s (once); graph top level {st.top_nodes}; "
              f"{len(st.sites)} sites ((kind, name, body kernel nodes true|iteration, "
              f"false): count {sites}); a replay ran {nodes:.1f} kernel nodes, {bodies:.2f} IF "
              f"bodies and {iterations:.2f} WHILE iterations over {st.replays} replays; taken "
              f"{taken} [{SMI}]")
    return out


def frame_fields(outs):
    """The host FrameOutputs of a run's chunks as {field: array}."""
    f = {k: np.concatenate([getattr(o, k) for o in outs])
         for k in ("status", "is_keyframe", "reset_backend", "num_inliers", "mean_reproj_err")}
    f["q"] = np.concatenate([o.T_c_w.q for o in outs])
    f["t"] = np.concatenate([o.T_c_w.t for o in outs])
    return f


def compare_runs(label, cap, eag) -> None:
    """Fail unless the captured and the eager run gave the same statuses,
    keyframes, reset flags, inlier counts, reprojection errors, poses and BA
    costs, bit for bit (the same kernels in the same order on the same
    draws)."""
    a, b = frame_fields(cap["outs"]), frame_fields(eag["outs"])
    diff = [k for k in a if not np.array_equal(a[k], b[k])]
    if cap["costs"] != eag["costs"]:
        diff.append("ba_costs")
    print(f"{label}: captured vs eager over {len(a['status'])} frames, {len(cap['costs'])} BA "
          f"costs: {'bit-equal' if not diff else 'DIFFERENT in ' + ', '.join(diff)}")
    if diff:
        fail(f"{label}: the captured and the eager run differ in {diff}")


def phase_line(label, r, frames_s) -> str:
    return (f"{label}: {r['fps']:.2f} frames/s over frames {frames_s}; device busy "
            f"{r['busy']:.3f}; {r['syncs_per_frame']:.2f} host syncs a frame in a chunk's step "
            f"(frames {r['sync_frames']}, the chunk end apart); {r['events_per_frame']:.0f} "
            f"device kernel events a frame (profiled frames {r['profiled']}) [{SMI}]")


SLICE_BOUNDS = (0, WARM_FRAMES, WARM_FRAMES + SYNC_FRAMES,
                WARM_FRAMES + SYNC_FRAMES + PROFILE_FRAMES, N_FRAMES)


def run_slice(cfg, scfg, cam, device, eager: bool = False):
    """The stereo slice: SlamSystem.process_frames over a rendered orbit —
    the captured step, or with `eager` the eager composition on the same
    frames and draws.  Chunks: the first (the capture), one whose step's
    host syncs are counted, one profiled, the timed rest."""
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    label = "slice eager" if eager else "slice"
    poses, imgs0, imgs1, _ = orbit_frames(scfg)
    slam = SlamSystem(cfg, cam, device=device, seed=0)
    if eager:
        use_eager_chunks(slam)
    else:
        capture_first(slam, "stereo", label, frame_inputs(device, imgs0, imgs1, "stereo"))
    syncs = {}
    count_chunk_syncs(slam, 2, syncs)
    reset_counts()
    outs, times = [], []
    b = SLICE_BOUNDS
    for k, (a, c) in enumerate(zip(b[:-1], b[1:])):
        def run(a=a, c=c):
            outs.append(slam.process_frames(imgs0[a:c], imgs1[a:c]))
            torch.cuda.synchronize()

        torch.cuda.synchronize()
        if k == 2:
            c0 = read_counts()
            _, dev_ms, n_events, names, _ = profile_window(run)
            replayed = replay_launches(names, c0)
            continue
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    counted = read_counts()
    captured = bool(getattr(slam, "_captured", None))
    launches = path_launches(counted, replayed, captured)
    timed = b[-1] - b[-2]
    r = {"outs": outs, "costs": list(slam.ba_costs), "fps": timed / times[-1],
         "first_chunk_s": times[0], "syncs_per_frame": syncs["syncs"] / SYNC_FRAMES,
         "sync_frames": f"{b[1]}..{b[2] - 1}", "profiled": f"{b[2]}..{b[3] - 1}",
         "events_per_frame": n_events / PROFILE_FRAMES, "launches": launches}
    r["busy"] = dev_ms / PROFILE_FRAMES / (1000.0 * times[-1] / timed)

    status = np.concatenate([o.status for o in outs])
    n_kf = int(np.concatenate([o.is_keyframe for o in outs]).sum())
    C_est = slam.trajectory_cam_centers()
    err = ate(C_est, np.asarray([-R.T @ t for (R, t) in poses]))
    bound_m = 0.02 * 0.02 * N_FRAMES + 0.01        # tests/test_tracker.py:97
    print(f"{label}: {N_FRAMES} frames, {n_kf} keyframes, statuses {np.bincount(status)}, "
          f"ATE {err:.5f} m (bound {bound_m:.5f}), {slam.n_valid_corrections} valid BA "
          f"corrections; first chunk (frames 0..{b[1] - 1}) {times[0]:.2f} s")
    print(phase_line(label, r, f"{b[-2]}..{b[-1] - 1}"))
    r["graph"] = graph_report(slam, label)
    print(launch_line(label, counted, replayed, captured, r["profiled"]))
    if not np.all(status[1:] == 1):
        fail(f"{label} frames not TRACKING: {status.tolist()}")
    if not np.isfinite(C_est).all() or C_est.shape != (N_FRAMES, 3):
        fail(f"{label} trajectory not finite / wrong shape")
    if not err < bound_m:
        fail(f"{label} ATE {err} over bound {bound_m}")
    if slam.n_valid_corrections < 1:
        fail(f"{label}: no valid BA correction")
    if eager:
        # The pyramid runs once a frame, before any cond: 3 levels a frame.
        if counted["grad_blur"] != 3 * N_FRAMES:
            fail(f"{label}: grad_blur launched {counted['grad_blur']} times, expected "
                 f"{3 * N_FRAMES}")
        if counted["schur_step"] < 1:
            fail(f"schur_step never launched on the {label}")
    else:
        check_in_graph(label, replayed, ("grad_blur", "schur_step"))
        # The whole frame step is in the graph: no wrapper of its kernels ran.
        if counted["grad_blur"] or counted["schur_step"]:
            fail(f"{label}: grad_blur or schur_step launched outside the graph: {counted}")
        print(f"{label}: grad_blur launched {replayed['grad_blur']} times in the "
              f"{PROFILE_FRAMES} profiled replays (3 a frame: {3 * PROFILE_FRAMES})")
    if not eager:
        from flvis_tpu_torch.backend import window_ba

        t0 = time.perf_counter()
        for _ in range(5):
            res = window_ba.optimize(cfg.backend, cam, slam.ba_state)
        torch.cuda.synchronize()
        print(f"window BA {1000.0 * (time.perf_counter() - t0) / 5:.2f} ms per keyframe "
              f"(optimize on the final window, eager, cost {float(res.cost):.4f})")
    return r


def check_rare_branches(cfg, scfg, cam, device) -> None:
    """Both rare branches inside the graph against the eager composition:
    two blank frames (the first escaped, its starved BA taking the PnP
    rescue; the second FAIL; the next frame re-initialises through the
    status cond's init side, with a backend reset), and, with min_inliers
    above the slot count, the PnP rescue on real matches at every tracking
    frame.  Outputs and BA costs bit-equal; the taken counts show the
    sides."""
    import dataclasses

    from flvis_tpu_torch.io.synthetic import PlanarScene, orbit_trajectory
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    n = 16
    scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
    frames = [scene.render(R, t) for (R, t) in orbit_trajectory(n, step=0.02)]
    starved = cfg.replace(frontend=dataclasses.replace(
        cfg.frontend, min_inliers=cfg.frontend.num_slots + 1))
    for name, ccfg, blank in (("blank frames", cfg, (6, 7)), ("starved frames", starved, ())):
        imgs0 = np.stack([u8(f[0]) for f in frames])
        imgs1 = np.stack([u8(f[1]) for f in frames])
        imgs0[list(blank)] = 0
        imgs1[list(blank)] = 0
        runs = []
        for eager in (False, True):
            slam = SlamSystem(ccfg, cam, device=device, seed=0)
            if eager:
                use_eager_chunks(slam)
            runs.append({"outs": [slam.process_frames(imgs0, imgs1)],
                         "costs": list(slam.ba_costs), "slam": slam})
        compare_runs(f"rare branches, {name}", runs[0], runs[1])
        st = next(iter(runs[0]["slam"]._captured.values())).step
        taken = st.taken_by_name()
        status = runs[0]["outs"][0].status
        print(f"rare branches, {name}: statuses {status.tolist()}; taken (true, false) "
              f"{taken} [{SMI}]")
        rescued, inits = taken["pnp_rescue"][0], taken["status"][1]
        if name == "blank frames" and not (inits >= 2 and rescued >= 1
                                           and status[blank[1]] == 2):
            fail(f"rare branches, blank frames: no FAIL and re-init inside the graph ({taken})")
        if name == "starved frames" and rescued < 2:
            fail(f"rare branches, starved frames: the PnP rescue ran {rescued} times")


class StageTimer:
    """Synced host time, calls and work units (units(args) a call; 1 by
    default) of the headline's stages.  A stage wrapped with probe_every = k
    is probed after every k-th call (up to PROBES of them): the same call
    once more under the sync debug mode and PROBE_CALLS times more under
    torch.profiler (the stages are functional), untimed and left out of the
    launch counts; the probe keeps host syncs and device events per call
    (the port's kernels by their launch counts) and the call's units.  The
    probes' wall time (probe_s) is left out of every enclosing timed call,
    and the phases leave it out of their frames/s."""

    PROBES, PROBE_CALLS = 8, 10

    def __init__(self, probe: bool = True):
        self.probe = probe      # off: no stage is probed (an eager run, whose loop node
                                # and stages the captured run's probes already read)
        self.ms, self.calls, self.units, self._real = {}, {}, {}, []
        self.probe_s = 0.0      # wall seconds spent in probes
        self.probed = {}        # label -> [(device events, host syncs, units)] of probed calls
        self.on = True          # off: calls pass through untimed

    def patch(self, obj, name, fn):
        """Replace obj.name by fn until restore()."""
        self._real.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    def wrap(self, obj, name, label, probe_every: int = 0, units=None):
        real = getattr(obj, name)

        def timed(*a, **kw):
            if not self.on:
                return real(*a, **kw)
            torch.cuda.synchronize()
            t0, p0 = time.perf_counter(), self.probe_s
            out = real(*a, **kw)
            torch.cuda.synchronize()
            n = units(a) if units else 1
            dt = time.perf_counter() - t0 - (self.probe_s - p0)
            self.ms[label] = self.ms.get(label, 0.0) + 1000.0 * dt
            self.calls[label] = self.calls.get(label, 0) + 1
            self.units[label] = self.units.get(label, 0) + n
            probed = self.probed.setdefault(label, [])
            if (self.probe and probe_every and self.calls[label] % probe_every == 0
                    and len(probed) < self.PROBES):
                tp = time.perf_counter()
                probed.append(self._probe(real, a, kw) + (n,))
                self.probe_s += time.perf_counter() - tp
            return out

        self.patch(obj, name, timed)

    @classmethod
    def _probe(cls, real, a, kw):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        counters = [fn for fns in kernels().values() for fn in fns]
        counts = [fn.launches for fn in counters]
        syncs = host_syncs(lambda: real(*a, **kw))
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(cls.PROBE_CALLS):
                real(*a, **kw)
            torch.cuda.synchronize()
        # The port's own kernels by their launch counts (the tracer loses
        # them in profiles this short), every other device event by the
        # profile; then the counts as they were: the repeats are not the
        # path's launches.
        ours = sum(fn.launches for fn in counters) - sum(counts)
        fns = [f for v in KERNEL_FNS.values() for f in v]
        others = sum(e.device_type == DeviceType.CUDA and not any(f in e.name for f in fns)
                     for e in p.events())
        for fn, c in zip(counters, counts):
            fn.launches = c
        return round(ours / (cls.PROBE_CALLS + 1) + others / cls.PROBE_CALLS), syncs

    def per_unit(self, label):
        """(synced ms per unit over every call, device events per unit: the
        probed calls' mean events a call times calls over units, or None)."""
        p = self.probed.get(label, [])
        ev = (sum(e for e, _, _ in p) / len(p) * self.calls[label] / self.units[label]
              if p else None)
        return self.ms[label] / self.units[label], ev

    def probe_line(self, label) -> str:
        """label's ms per call, and its probed calls' device events and host
        syncs."""
        p = self.probed.get(label, [])
        return (f"{label}: {self.ms[label] / self.calls[label]:.4f} ms per call over "
                f"{self.calls[label]} timed calls; {len(p)} probed calls: device events per "
                f"call {sorted(e for e, _, _ in p)}, host syncs {sorted(s for _, s, _ in p)}")

    def restore(self):
        for obj, name, real in reversed(self._real):
            setattr(obj, name, real)


@once(shared=True)
def loop_frames(scfg):
    """The frames of loop_sequence: poses, uint8 left and right images, Z16
    depth images, and the path length."""
    from flvis_tpu_torch.io.synthetic import PlanarScene

    scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
    half = LOOP_FRAMES // 2
    xs = np.concatenate([np.linspace(0.0, 0.02 * half, half),
                         np.linspace(0.02 * half, 0.01, LOOP_FRAMES - half)])
    poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    frames = [scene.render(R, t) for (R, t) in poses]
    return (poses, np.stack([u8(f[0]) for f in frames]), np.stack([u8(f[1]) for f in frames]),
            np.stack([z16(f[2]) for f in frames]), float(np.sum(np.abs(np.diff(xs)))))


def loop_sequence(scfg, depth: bool = False):
    """The bench's loop-event sequence (bench.py:368-380): 256 frames out
    along x and back, with IMU split per frame; with `depth`, the second
    image of each frame is its Z16 depth image (z16) instead of the right
    image."""
    from flvis_tpu_torch.io.synthetic import imu_from_trajectory

    poses, left, right, depth_imgs, path = loop_frames(scfg)
    t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
    accs, gyros, imuts = [], [], []
    prev = -np.inf
    for ft in frame_t:
        m = (t_imu > prev) & (t_imu <= ft)
        accs.append(acc[m]); gyros.append(gyro[m]); imuts.append(t_imu[m])
        prev = ft
    return (poses, left, depth_imgs if depth else right, frame_t, accs, gyros, imuts, path)


NESTED = ("verification",)              # timed inside "loop gate decisions + verify" too


def verified_pairs(args) -> int:
    """The distinct candidate pairs of one verification call: a bucket
    (iis, jjs), padded with its last pair, or one pair (i, j)."""
    i, j = args[0], args[1]
    return len(set(zip(i, j))) if isinstance(i, (list, tuple)) else 1


def wrap_loop_node(timer, lc, accepted):
    """Time the chunked loop node's stages of one LoopCloser, probe its
    verification calls (device events and host syncs per verified pair),
    and append each accepted closure's (i, j, n_match, n_inl, T_ij as q +
    t) to `accepted`.  The verification stage is _verify_device_batch (a
    bucket of pairs) where the tree has it, else _verify_device (one pair)."""
    timer.wrap(lc, "add_keyframes_batch", "loop ingest")
    timer.wrap(lc, "gate_candidates", "loop gate")
    timer.wrap(lc, "dispatch_verify", "loop gate decisions + verify")
    name = "_verify_device_batch" if hasattr(lc, "_verify_device_batch") else "_verify_device"
    timer.wrap(lc, name, "verification", probe_every=1, units=verified_pairs)
    timer.wrap(lc, "resolve_verify", "loop accept")
    timer.wrap(lc, "optimize_graph", "pgo")
    real = lc._verify_accept

    def accept(i, j, row):
        out = real(i, j, row)
        if out is not None:
            r = np.asarray(row, np.float64)
            accepted.append((i, j, int(r[7]), int(r[8]), r[:7].tolist()))
        return out

    timer.patch(lc, "_verify_accept", accept)


def verification_summary(timer, accepted, label) -> dict:
    """Print and return a phase's verification readings: synced ms and
    device events per verified pair, calls (buckets) and the closures
    (accepted: wrap_loop_node's list, or one such list a sequence, whose
    rows then lead with the sequence)."""
    if not timer.calls.get("verification"):
        fail(f"{label}: no verification ran")
    ms, ev = timer.per_unit("verification")
    p = timer.probed.get("verification", [])
    if accepted and isinstance(accepted[0], list):
        accepted = [(q,) + c for q, seq in enumerate(accepted) for c in seq]
    out = {"pairs": timer.units["verification"], "calls": timer.calls["verification"],
           "ms_per_pair": ms, "events_per_pair": ev, "closures": accepted}
    probed = (f"{ev:.1f} device events per verified pair over {len(p)} probed calls (per call "
              f"{[e for e, _, _ in p]}, pairs {[n for _, _, n in p]}, host syncs "
              f"{[h for _, h, _ in p]})" if p else "not probed")
    print(f"{label} verification: {ms:.4f} synced ms per verified pair over {out['pairs']} "
          f"pairs in {out['calls']} calls; {probed}")
    return out


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
        timer.wrap(mod, name, f"{mod.__name__.rsplit('.', 1)[1]}.{name}",
                   probe_every=16 if name == "imu_feed_batch" else 0)


HEADLINE_BOUNDS = (0, CHUNK, CHUNK + SYNC_FRAMES, 2 * CHUNK, 2 * CHUNK + PROFILE_FRAMES,
                   3 * CHUNK, LOOP_FRAMES)


def run_headline(cfg, scfg, cam, device, eager: bool = False):
    """SlamSystem(use_imu=True, use_loop=True).process_frames_vio over the
    loop-event sequence, the loop node resolving one chunk late, then
    flush_loop — the captured step, or with `eager` the eager composition
    on the same frames and draws (a tree without a captured step runs its
    own).  Chunks (HEADLINE_BOUNDS): the first (the capture), one whose
    step's host syncs are counted, timed ones, a profiled one in the revisit
    leg.  Returns the run's readings: outputs, BA costs, closures, ATE,
    launches, frames/s, busy share, syncs and events a frame, the
    verification summary."""
    from flvis_tpu_torch.geometry import se3
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    label = "headline eager" if eager else "headline"
    poses, imgs0, imgs1, frame_t, accs, gyros, imuts, path = loop_sequence(scfg)
    slam = SlamSystem(cfg, cam, device=device, seed=0, T_i_c=se3.identity(device=device),
                      use_imu=True, use_loop=True)
    if eager:
        use_eager_chunks(slam)
    else:
        capture_first(slam, "vio", label, frame_inputs(device, imgs0, imgs1, "vio"))
    lc = slam.loop_closer
    timer = StageTimer(probe=not eager)
    accepted = []
    wrap_loop_node(timer, lc, accepted)
    pgo_calls = record_pgo(timer)
    syncs = {}
    count_chunk_syncs(slam, 2, syncs)
    reset_counts()
    t0 = time.perf_counter()
    outs, plain_s, first_s, staged = [], 0.0, 0.0, 0.0
    b = HEADLINE_BOUNDS

    def staged_ms():
        return sum(v for k, v in timer.ms.items() if k not in NESTED)

    for k, (a, c) in enumerate(zip(b[:-1], b[1:])):
        sl = slice(a, c)

        def run():
            tc, pc = time.perf_counter(), timer.probe_s
            outs.append(slam.process_frames_vio(imgs0[sl], imgs1[sl], ts=frame_t[sl],
                                                imu_acc=accs[sl], imu_gyro=gyros[sl],
                                                imu_t=imuts[sl]))
            torch.cuda.synchronize()
            return time.perf_counter() - tc - (timer.probe_s - pc)

        torch.cuda.synchronize()
        if k == 0:
            first_s = run()
        elif k == 1:
            run()
        elif k != 3:
            s0 = staged_ms()
            plain_s += run()
            staged += staged_ms() - s0
        else:
            # The profiled window keeps its stage calls out of the stage timer.
            timer.on = False
            c0 = read_counts()
            wall, dev_ms, n_events, names, host = profile_window(run)
            replayed = replay_launches(names, c0)
            timer.on = True
            print(f"{label} profile, top host ops (self CPU ms): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in
                              sorted(host.items(), key=lambda kv: -kv[1])[:8]))
    tc, pc, s0 = time.perf_counter(), timer.probe_s, staged_ms()
    slam.flush_loop()                   # the last chunks' gate and verification
    torch.cuda.synchronize()
    plain_s += time.perf_counter() - tc - (timer.probe_s - pc)
    staged += staged_ms() - s0
    wall_s = time.perf_counter() - t0
    counted = read_counts()
    captured = bool(getattr(slam, "_captured", None))
    launches = path_launches(counted, replayed, captured)
    timer.restore()
    # Device busy share: profiled device time per frame over the mean time of
    # the timed frames (the profiler itself slows the host).
    n_plain = (b[3] - b[2]) + (b[6] - b[4])        # the timed chunks' frames
    frame_ms = 1000.0 * plain_s / n_plain
    r = {"fps": n_plain / plain_s, "busy": dev_ms / PROFILE_FRAMES / frame_ms,
         "syncs_per_frame": syncs["syncs"] / SYNC_FRAMES, "sync_frames": f"{b[1]}..{b[2] - 1}",
         "profiled": f"{b[3]}..{b[4] - 1}", "events_per_frame": n_events / PROFILE_FRAMES,
         "first_chunk_s": first_s, "launches": launches, "costs": list(slam.ba_costs),
         "outs": outs}
    print(f"{label} profile, frames {b[3]}..{b[4] - 1}: wall {wall:.1f} ms with the profiler "
          f"on, device kernel time {dev_ms:.1f} ms, {n_events} device kernel events; timed "
          f"frames {frame_ms:.1f} ms each -> device busy {r['busy']:.3f} [{SMI}]")

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
    verify = verification_summary(timer, accepted, label)
    r.update(ate=(ate_raw, ate_cor), verify=verify,
             closures=[tuple(x[:4]) for x in accepted])
    print(f"{label}: {LOOP_FRAMES} frames, {n_kf} keyframes ({lc.count} in the loop "
          f"store), statuses {np.bincount(status)}, {len(closures)} closures "
          f"{closures[:8]}{'...' if len(closures) > 8 else ''}, {verify['pairs']} verified "
          f"pairs in {verify['calls']} verification calls")
    print(f"{label} ATE: odometry {ate_raw:.5f} m, loop-corrected {ate_cor:.5f} m "
          f"(bound {bound_m:.5f} over a {path:.2f} m path); T_map_odom t "
          f"{lc.T_map_odom.t.cpu().numpy().round(5).tolist()}")
    print(phase_line(label, r, f"{b[2]}..{b[3] - 1}, {b[4]}..{b[6] - 1} + flush_loop")
          + f"; first chunk (frames 0..{b[1] - 1}) {first_s:.2f} s; {wall_s:.1f} s for the "
          f"whole phase incl. the profiled window and {timer.probe_s:.1f} s of stage probes")
    print(f"{label} loop node stages over the unprofiled chunks, synced host ms in all (per "
          "call x calls): " + ", ".join(f"{k} {v:.0f} ({v / timer.calls[k]:.2f} "
                                        f"x{timer.calls[k]})" for k, v in timer.ms.items())
          + f"; over the timed chunks {staged:.0f} in the loop node and "
          f"{1000.0 * plain_s - staged:.0f} outside it")
    r["graph"] = graph_report(slam, label)
    print(launch_line(label, counted, replayed, captured, r["profiled"])
          + f" (IMU-initialised frames {init_frames})")
    if not np.all(status[1:] == 1):
        fail(f"{label} frames not TRACKING: {np.flatnonzero(status != 1).tolist()}")
    if not (np.isfinite(C_cor).all() and C_cor.shape == (LOOP_FRAMES, 3)):
        fail(f"{label} trajectory not finite / wrong shape")
    if not closures:
        fail(f"{label} run accepted no loop closure")
    if not (ate_raw < bound_m and ate_cor < bound_m):
        fail(f"{label} ATE {ate_raw} / {ate_cor} over bound {bound_m}")
    if captured:
        check_in_graph(label, replayed, IN_GRAPH)
    elif launches["imu_chain"] < init_frames:
        fail(f"imu_chain launched {launches['imu_chain']} times < {init_frames} frames")
    for name in ("fastblur", "sweep"):
        if launches[name] < n_kf:
            fail(f"{name} launched {launches[name]} times < {n_kf} keyframes")
    if launches["hamming"] < max(verify["calls"], 1):
        fail(f"hamming launched {launches['hamming']} times < {verify['calls']} verification "
             "calls")
    check_pgo_repeats(pgo_calls)
    return r


def record_pgo(timer):
    """Keep the arguments and result of every pose_graph.optimize call until
    timer.restore()."""
    from flvis_tpu_torch.loop import pose_graph

    calls = []
    real = pose_graph.optimize

    def recorded(graph, fixed, **kw):
        out = real(graph, fixed, **kw)
        calls.append((graph, fixed, kw, out))
        return out

    timer.patch(pose_graph, "optimize", recorded)
    return calls


def check_pgo_repeats(calls):
    """PGO on the headline's last graph, twice more: the node poses must
    equal the run's own bit for bit (fixed-order assembly, no float
    atomics)."""
    from flvis_tpu_torch.loop import pose_graph

    if not calls:
        fail("the headline ran no pose-graph optimisation")
    graph, fixed, kw, (ref, ref_cost) = calls[-1]
    again = [pose_graph.optimize(graph, fixed, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(g.node_q, ref.node_q) and torch.equal(g.node_t, ref.node_t)
               and torch.equal(c, ref_cost) for g, c in again)
    print(f"PGO repeats: the headline's last graph ({int(graph.node_valid.sum())} nodes, "
          f"{int(graph.edge_valid.sum())} edges, {len(calls)} PGO calls in the phase) "
          f"optimised twice more: {'bit-equal' if same else 'DIFFERENT'} to the run's result")
    if not same:
        fail("PGO does not repeat bit for bit on the card")


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


@once
def multiseq_sequence(scfg):
    """Phase c's input: S = MS_SEQS sequences of a 64-frame out-and-back (0
    → 0.6 m → back, plane at 8 m) with IMU; sequences 2..S-1 rolled
    horizontally by 7·s px (bench.py:411-418), 0 and 1 the same frames.
    Returns (poses, imgs0, imgs1 (S, n, H, W), ts (S, n), per-chunk IMU
    packets (S, T, 16, ·), path length)."""
    from flvis_tpu_torch.io.synthetic import PlanarScene, imu_from_trajectory
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
    return poses, imgs0, imgs1, bc(np.asarray(frame_t, np.float32)), imu, path


def multiseq_config(cfg):
    # 64 frames hold ~20 keyframes: the loop gate starts at keyframe 10 and
    # searches 8 behind (tests/test_multiseq_loop.py:44-48), not 50/50.
    import dataclasses

    return cfg.replace(loop=dataclasses.replace(cfg.loop, kf_start=10, kf_dist=8))


def chunk_inputs(device, imgs0, imgs1, ts, imu, k):
    """Chunk k of phase c as MultiSeqSlam._run_chunk takes it: (S, T, ...)
    tensors on the device."""
    sl = slice(k * MS_CHUNK, (k + 1) * MS_CHUNK)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (imgs0[:, sl], imgs1[:, sl], ts[:, sl]) + tuple(imu[k]))


def replay_readings(step, reps: int = 5):
    """(device ms, host ms) of one replay of a captured step on the inputs
    it holds, each the median of `reps` replays from one state (the carry
    copied back in before each): a replay is enqueued while the card sleeps
    0.25 s, so its CUDA-event time is the graph's own device time, not its
    launch's; the host time is the cudaGraphLaunch call's.  Fails unless
    every replay gives the first one's carry and outputs bit for bit (a
    race between the graph's branches would show as a difference).  The
    carry and the taken counts are left as they were."""
    from flvis_tpu_torch.utils.tree import tree_leaves

    snap = [t.clone() for t in tree_leaves(step.carry)]
    taken = step.taken.clone()
    dev, host, bits = [], [], []
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        for d, s in zip(tree_leaves(step.carry), snap):
            d.copy_(s)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(0.25 * sm_clock_mhz() * 1e6))
        e0.record()
        t0 = time.perf_counter()
        step.graph.replay()
        host.append(1000.0 * (time.perf_counter() - t0))
        e1.record()
        torch.cuda.synchronize()
        dev.append(e0.elapsed_time(e1))
        bits.append(torch.cat([t.reshape(-1).view(torch.uint8)
                               for t in tree_leaves((step.carry, step.ys))]))
    if not all(torch.equal(b, bits[0]) for b in bits):
        fail(f"{step.name}: {reps} replays from one state gave different bits")
    for d, s in zip(tree_leaves(step.carry), snap):
        d.copy_(s)
    step.taken.copy_(taken)
    torch.cuda.synchronize()
    return statistics.median(dev), statistics.median(host)


def branch_concurrency(cfg, cam, device, ms, imgs0, imgs1, ts, imu) -> dict:
    """How far the S branches of ms's captured graph run side by side: one
    replay's device time against S × that of a one-branch graph of the
    same step (MultiSeqSlam(num_seqs=1) over sequence 0's frames, captured
    and run to the same frame), both on their last frame from their last
    state (a window-solve frame), and each graph's cudaGraphLaunch host
    time."""
    from flvis_tpu_torch.parallel.multiseq_loop import MultiSeqSlam

    one = MultiSeqSlam(cfg, cam, num_seqs=1, use_imu=True, use_loop=False, ba_every=2,
                       device=device)
    for k in range(MS_CHUNKS):
        xs = tuple(x[:1] for x in chunk_inputs(device, imgs0, imgs1, ts, imu, k))
        one._run_chunk("vio", xs)
    S = ms.S
    dev_s, host_s = replay_readings(ms._captured["vio"].step)
    dev_1, host_1 = replay_readings(one._captured["vio"].step)
    out = {"replay_ms": dev_s, "one_branch_ms": dev_1, "overlap": S * dev_1 / dev_s,
           "launch_host_ms": host_s, "one_branch_launch_host_ms": host_1}
    print(f"multi-sequence branch concurrency: one replay of the {S}-branch graph "
          f"{dev_s:.2f} ms on the device against {S} x the 1-branch graph's {dev_1:.2f} ms = "
          f"{S * dev_1:.2f} ms: the branches overlap {out['overlap']:.2f}x ({S:.1f}x is full "
          f"overlap, 1.0x none); host time of one cudaGraphLaunch {host_s:.2f} ms ({S} "
          f"branches) and {host_1:.2f} ms (1 branch); 1-branch capture "
          f"{one._captured['vio'].step.seconds} [{SMI}]")
    return out


MS_SYNC_CHUNK, MS_PROFILE_CHUNK = 1, 3


def run_multiseq(cfg, scfg, cam, device, eager: bool = False):
    """MultiSeqSlam(num_seqs=8, use_imu=True, use_loop=True, ba_every=2,
    pipelined=True) over 8 chunks of 8 frames (multiseq_sequence) — the
    captured step (one graph a frame, the 8 sequences its branches), or
    with `eager` the eager loop over the same step on the same frames and
    draws (a tree without a captured step runs its own).  Chunks: the
    first, one whose step's host syncs are counted, one profiled, the timed
    rest (+ flush).  Returns the run's readings: packed outputs, closures,
    ATE, launches, sequence-frames/s, busy share, syncs, the verification
    summary."""
    from flvis_tpu_torch.parallel.multiseq_loop import MultiSeqSlam

    label = "multi-sequence eager" if eager else "multi-sequence"
    S, T, n = MS_SEQS, MS_CHUNK, MS_CHUNK * MS_CHUNKS
    poses, imgs0, imgs1, ts, imu, path = multiseq_sequence(scfg)
    mcfg = multiseq_config(cfg)
    ms = MultiSeqSlam(mcfg, cam, num_seqs=S, use_imu=True, use_loop=True, ba_every=2,
                      pipelined=True, device=device)
    if eager:
        use_eager_chunks(ms)
    else:
        capture_first(ms, "vio", label, chunk_inputs(device, imgs0, imgs1, ts, imu, 0))
    timer = StageTimer(probe=not eager)
    if eager or not hasattr(ms, "_captured_step"):
        wrap_frame_stages(timer)
    accepted = [[] for _ in ms.loopers]
    for lc, acc in zip(ms.loopers, accepted):
        wrap_loop_node(timer, lc, acc)
    syncs = {}
    if hasattr(ms, "_run_chunk"):
        count_chunk_syncs(ms, MS_SYNC_CHUNK + 1, syncs)
    reset_counts()
    rets, timed_s, timed_frames, first_s = [], 0.0, 0, 0.0
    replayed, prof = {k: 0 for k in KERNEL_FNS}, None
    t0 = time.perf_counter()
    for k in range(MS_CHUNKS):
        sl = slice(k * T, (k + 1) * T)

        def run(sl=sl, k=k):
            tc, pc = time.perf_counter(), timer.probe_s
            rets.append(ms.process_chunk_vio(imgs0[:, sl], imgs1[:, sl], ts[:, sl], *imu[k]))
            torch.cuda.synchronize()
            return time.perf_counter() - tc - (timer.probe_s - pc)

        torch.cuda.synchronize()
        if k in (MS_SYNC_CHUNK, MS_PROFILE_CHUNK):
            # Kept out of the stage timer: its synced calls would count as
            # the chunk's host syncs, and the profiler slows them.
            timer.on = False
            if k == MS_SYNC_CHUNK:
                run()
            else:
                c0 = read_counts()
                prof = device_window(run)
                replayed = replay_launches(prof[4], c0)
            timer.on = True
        elif k == 0:
            first_s = run()
        else:
            timed_s += run()
            timed_frames += T
    tc, pc = time.perf_counter(), timer.probe_s
    rets.append(ms.flush())
    torch.cuda.synchronize()
    timed_s += time.perf_counter() - tc - (timer.probe_s - pc)
    wall = time.perf_counter() - t0 - timer.probe_s
    counted = read_counts()
    captured = bool(getattr(ms, "_captured", None))
    launches = path_launches(counted, replayed, captured)
    timer.restore()

    outs = [r for r in rets if r is not None]
    packed = np.concatenate(outs, axis=1)
    status = packed[:, :, 2].astype(np.int32)
    C_gt = np.asarray([-R.T @ t for (R, t) in poses])
    bound_m = 0.02 * path + 0.01
    ates = [ate(ms.trajectory_cam_centers(s), C_gt) for s in range(S)]
    ates_cor = [ate(ms.trajectory_cam_centers(s, loop_corrected=True), C_gt) for s in range(S)]
    pairs = [[(c.kf_i, c.kf_j) for c in lc.closures] for lc in ms.loopers]
    frame_ms = 1000.0 * timed_s / timed_frames
    p_wall, p_sum, p_union, p_events, _ = prof
    r = {"packed": packed, "ate": (ates, ates_cor), "keyframes": [lc.count for lc in ms.loopers],
         "closures": [[tuple(c[:4]) for c in seq] for seq in accepted],
         "fps": S * timed_frames / timed_s, "busy": p_union / T / frame_ms,
         "overlap_profiled": p_sum / max(p_union, 1e-9), "launches": launches,
         "syncs_per_frame": syncs["syncs"] / T if syncs else float("nan"),
         "events_per_frame": p_events / T, "first_chunk_s": first_s}
    staged = sum(v for k, v in timer.ms.items() if k not in NESTED)
    print(f"{label}: {S} sequences x {n} frames in {len(outs)} chunks of {T}, "
          f"{r['fps']:.2f} sequence-frames/s over chunks 2, 4..{MS_CHUNKS - 1} + flush "
          f"({frame_ms:.1f} ms a frame of the {S} sequences; {S * n / wall:.2f} over the whole "
          f"run, {wall:.1f} s, stage probes' {timer.probe_s:.1f} s left out; first chunk "
          f"{first_s:.2f} s), keyframes {r['keyframes']}, closures {[len(p) for p in pairs]}")
    print(f"{label} profile, chunk {MS_PROFILE_CHUNK} (frames {MS_PROFILE_CHUNK * T}.."
          f"{(MS_PROFILE_CHUNK + 1) * T - 1}): wall {p_wall:.1f} ms with the profiler on, "
          f"{p_events} device events, their time summed {p_sum:.1f} ms and as a union of "
          f"intervals {p_union:.1f} ms ({r['overlap_profiled']:.2f} events in flight on "
          f"average) -> device busy {r['busy']:.3f} of the timed frames' {frame_ms:.1f} ms; "
          f"{r['syncs_per_frame']:.2f} host syncs a frame in chunk {MS_SYNC_CHUNK}'s step "
          f"[{SMI}]")
    print(f"{label} ATE per sequence (bound {bound_m:.5f} over a {path:.2f} m path): "
          f"odometry {[round(a, 5) for a in ates]}, loop-corrected "
          f"{[round(a, 5) for a in ates_cor]}; sequence 0 closures {pairs[0][:6]}...")
    print(f"{label} stages, synced host ms in all (per call x calls): "
          + ", ".join(f"{k} {timer.ms[k]:.0f} ({timer.ms[k] / timer.calls[k]:.2f} "
                      f"x{timer.calls[k]})" for k in timer.ms)
          + f"; outside these stages {1000.0 * wall - staged:.0f}")
    if "vimotion.imu_feed_batch" in timer.ms:
        print(f"{label} {timer.probe_line('vimotion.imu_feed_batch')}")
    verify = verification_summary(timer, accepted, label)
    r["verify"] = verify
    r["graph"] = graph_report(ms, label)
    print(launch_line(label, counted, replayed, captured, f"{MS_PROFILE_CHUNK * T}.."
                      f"{(MS_PROFILE_CHUNK + 1) * T - 1}"))
    for s, lc in enumerate(ms.loopers):
        errs = closure_errors(lc, C_gt)
        if not errs:
            continue                    # fails below: every sequence must close
        worst = max(errs, key=lambda e: e[2])
        print(f"{label} closures of sequence {s}: |T_map_odom.t| "
              f"{float(torch.linalg.vector_norm(lc.T_map_odom.t)):.5f} m; translation error "
              f"against the ground truth, loop edges mean "
              f"{np.mean([e[2] for e in errs]):.5f} / max {worst[2]:.5f} m (pair "
              f"{worst[:2]}), odometry between the same keyframes mean "
              f"{np.mean([e[3] for e in errs]):.5f} / max {max(e[3] for e in errs):.5f} m; "
              f"pairs {[e[:2] for e in errs]}")
    if status.shape != (S, n) or not np.all(status[:, 1:] == 1):
        fail(f"{label} frames not TRACKING: {np.argwhere(status[:, 1:] != 1).tolist()}")
    if not all(a < bound_m and b < bound_m for a, b in zip(ates, ates_cor)):
        fail(f"{label} ATE {ates} / loop-corrected {ates_cor} over bound {bound_m}")
    if not all(pairs):
        fail(f"{label}: a sequence accepted no loop closure: {[len(p) for p in pairs]}")
    same = all(np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
               for a, b in zip(ms.trajectories[0], ms.trajectories[1]))
    if not (same and pairs[0] == pairs[1]):
        fail(f"{label}: sequences 0 and 1 (same frames, same draws) differ")
    for name in ("bowassign", "gather"):
        if launches[name] < 1:
            fail(f"{name} never launched on the {label} path")
    if launches["hamming"] < verify["calls"]:
        fail(f"hamming launched {launches['hamming']} times < {verify['calls']} verification "
             "calls")
    if captured:
        check_in_graph(label, replayed, IN_GRAPH)
        if syncs["syncs"]:
            fail(f"{label}: {syncs['syncs']} host syncs in a captured chunk's step")
        r["concurrency"] = branch_concurrency(mcfg, cam, device, ms, imgs0, imgs1, ts, imu)
    return r


def compare_multiseq(cap, eag) -> None:
    """Fail unless phase c's captured and eager runs gave the same packed
    outputs (statuses, poses, keyframes, inliers, errors), keyframe counts,
    closures (i, j, n_match, n_inl) and ATE, bit for bit."""
    diff = [k for k, a, b in (("outputs", cap["packed"], eag["packed"]),)
            if not np.array_equal(a, b)]
    diff += [k for k in ("keyframes", "closures", "ate") if cap[k] != eag[k]]
    n = sum(len(c) for c in cap["closures"])
    print(f"multi-sequence: captured vs eager over {cap['packed'].shape[:2]} sequence-frames, "
          f"{n} closures: {'bit-equal' if not diff else 'DIFFERENT in ' + ', '.join(diff)}")
    if diff:
        fail(f"multi-sequence: the captured and the eager run differ in {diff}")


def phase_c() -> int:
    """--phase-c: phase c, captured then eager, compared; the last line of
    output is a JSON object of the captured run's launches and
    verification summary.  main() runs it in a process of its own, whose
    graph is captured before the process's first trace: an 8-branch graph
    of (c)'s size, captured after torch.profiler had traced in the process,
    hits an illegal address when its replays are traced (torch 2.11, CUDA
    12.8, H100; tools/torch_profiler_fault.py)."""
    from flvis_tpu_torch.ops.kernels import _build

    global SMI
    SMI = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    device = torch.device("cuda", 0)
    _build.load_library()
    cfg, scfg = system_config()
    cam = make_camera(scfg, device)
    ms_r = run_multiseq(cfg, scfg, cam, device)
    ms_e = run_multiseq(cfg, scfg, cam, device, eager=True)
    compare_multiseq(ms_r, ms_e)
    phase_c_line(ms_r, ms_e)
    print(json.dumps({"launches": ms_r["launches"], "verify": ms_r["verify"]}))
    return 0


def run_own_process(*args) -> dict:
    """This script with `args` in a process of its own, its output shown as
    it printed it; returns its last line's readings."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), *args],
                          capture_output=True, text=True)
    lines = proc.stdout.splitlines()
    print("\n".join(lines[:-1] if proc.returncode == 0 else lines), flush=True)
    print(proc.stderr, file=sys.stderr, end="", flush=True)
    if proc.returncode != 0:
        fail(f"{' '.join(args)} failed ({proc.returncode})")
    return json.loads(lines[-1])


def phase_c_line(ms_r, ms_e) -> None:
    """Phase c's captured run beside its eager one, as phases a and b's."""
    g, c = next(iter(ms_r["graph"].values())), ms_r["concurrency"]
    print(f"phase c captured vs eager, same call: sequence-frames/s {ms_r['fps']:.2f} vs "
          f"{ms_e['fps']:.2f} ({ms_r['fps'] / ms_e['fps']:.2f}x); device busy "
          f"{ms_r['busy']:.3f} vs {ms_e['busy']:.3f}; host syncs a frame in a chunk's step "
          f"{ms_r['syncs_per_frame']:.2f} vs {ms_e['syncs_per_frame']:.2f}; device events a "
          f"frame of the {MS_SEQS} sequences {ms_r['events_per_frame']:.0f} vs "
          f"{ms_e['events_per_frame']:.0f}; a replay {g['kernel_nodes']:.1f} graph kernel "
          f"nodes, {g['if_bodies']:.2f} IF bodies and {g['while_iterations']:.2f} WHILE "
          f"iterations over {g['sites']} sites; branches overlap {c['overlap']:.2f}x; one "
          f"cudaGraphLaunch {c['launch_host_ms']:.2f} ms on the host; capture "
          f"{g['warmup']:.2f} s warm-up + {g['capture']:.2f} s [{SMI}]")


def run_phase_of(tree: str, phase: str) -> int:
    """Phase `phase` (b or c) of the port in `tree` (a checkout, e.g. a
    `git archive` of a parent commit) with this script's stage probes; the
    last line of output is a JSON object of its verification summary.
    compare_with_parent runs each phase in a process of its own, as main()
    runs this tree's phase c (phase_c)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import flvis_tpu_torch
    from flvis_tpu_torch.ops.kernels import _build

    # The tree's kernels built before the phases, as main() builds this tree's.
    print(f"phases of {Path(flvis_tpu_torch.__file__).parent}; kernel build "
          f"{_build.load_library()[1]['build_s']:.2f} s")
    device = torch.device("cuda", 0)
    global SMI
    SMI = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    cfg, scfg = system_config()
    cam = make_camera(scfg, device)
    run = run_headline if phase == "b" else run_multiseq
    print(json.dumps(run(cfg, scfg, cam, device)["verify"]))
    return 0


def compare_with_parent(tree: str, ours: dict) -> None:
    """Phases (b) and (c) of the tree at `tree`, each in a subprocess (its
    output shown under "parent|"), then its verification readings and
    closures beside this tree's: synced ms and device events per verified
    pair, and the accepted closures' (i, j), n_match, n_inl and T_ij."""
    t0 = time.perf_counter()
    theirs = {}
    for ph in ("b", "c"):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase-of",
                               tree, ph], capture_output=True, text=True)
        for line in proc.stdout.splitlines()[:-1] + proc.stderr.splitlines():
            print(f"parent| {line}")
        if proc.returncode != 0:
            fail(f"phase {ph} of {tree} failed ({proc.returncode})")
        theirs[ph] = json.loads(proc.stdout.splitlines()[-1])
    ours = json.loads(json.dumps(ours))          # tuples as the parent's JSON lists
    print(f"phases b and c of {tree}: {time.perf_counter() - t0:.1f} s")
    for ph in ("b", "c"):
        a, b = ours[ph], theirs[ph]
        print(f"verification per verified pair, phase {ph}: this tree {a['ms_per_pair']:.4f} ms "
              f"and {a['events_per_pair']:.1f} device events ({a['pairs']} pairs in "
              f"{a['calls']} calls); parent {b['ms_per_pair']:.4f} ms and "
              f"{b['events_per_pair']:.1f} events ({b['pairs']} pairs in {b['calls']} calls); "
              f"ratio {a['ms_per_pair'] / b['ms_per_pair']:.3f} ms, "
              f"{a['events_per_pair'] / b['events_per_pair']:.3f} events")
        # Rows (..., i, j, n_match, n_inl, T_ij as q + t), in the order accepted.
        ca, cb = a["closures"], b["closures"]
        same = [x[:-1] for x in ca] == [x[:-1] for x in cb]
        dT = max((abs(u - v) for x, y in zip(ca, cb) for u, v in zip(x[-1], y[-1])),
                 default=0.0)
        print(f"closures, phase {ph}: this tree {len(ca)}, parent {len(cb)}; (i, j, n_match, "
              f"n_inl) {'all equal' if same else 'DIFFERENT'}; max |T_ij difference| {dT:.3e}"
              + ("" if same else "; differing: " + str(
                  [(x[:-1], y[:-1]) for x, y in zip(ca, cb) if x[:-1] != y[:-1]][:8])))
        if not same:
            fail(f"phase {ph}: the closures differ from the parent's")


MMA_RATES_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
#define MMA(NAME, SHAPE_TYPES)                                                               \
  __device__ __forceinline__ void NAME(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,   \
                                       uint32_t b1) {                                      \
    asm volatile("mma.sync.aligned." SHAPE_TYPES " {%0, %1, %2, %3}, {%4, %5, %6, %7}, "   \
                 "{%8, %9}, {%0, %1, %2, %3};\n"                                            \
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                           \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));          \
  }
MMA(mma_and, "m16n8k256.row.col.s32.b1.b1.s32.and.popc")
MMA(mma_xor, "m16n8k256.row.col.s32.b1.b1.s32.xor.popc")
MMA(mma_s8, "m16n8k32.row.col.s32.s8.s8.s32")

template <int KIND, int CHAINS>
__global__ void chains(int* out, int iters, uint32_t seed) {
  const uint32_t a[4] = {seed ^ threadIdx.x, seed * 3u, seed + 7u, ~seed};
  const uint32_t b0 = seed * 11u + threadIdx.x, b1 = seed ^ 0x5555u;
  int acc[CHAINS][4];
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < 4; ++e) acc[c][e] = c;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (KIND == 0) mma_and(acc[c], a, b0, b1);
      else if (KIND == 1) mma_xor(acc[c], a, b0, b1);
      else mma_s8(acc[c], a, b0, b1);
    }
  int s = 0;
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int KIND>
int run(int chains_n, int blocks, int threads, int iters, int* out) {
  if (chains_n == 1) chains<KIND, 1><<<blocks, threads>>>(out, iters, 12345u);
  else chains<KIND, 8><<<blocks, threads>>>(out, iters, 12345u);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mma_rates(int kind, int chains_n, int blocks, int threads, int iters, int* out) {
  if (kind == 0) return run<0>(chains_n, blocks, threads, iters, out);
  if (kind == 1) return run<1>(chains_n, blocks, threads, iters, out);
  return run<2>(chains_n, blocks, threads, iters, out);
}
"""

MMA_FORMS = ((0, "b1 and.popc m16n8k256"), (1, "b1 xor.popc m16n8k256"), (2, "s8 m16n8k32"))
MMA_SHAPES = ((1, 1, 32), (8, 1, 32), (8, 1, 128), (8, 1, 256), (8, 1, 512), (8, 132, 256),
          (8, 132, 512))



def mma_rates() -> int:
    """Issue rate and latency of the warp-level mma.sync forms a Hamming
    distance can run on: m16n8k256 .b1 with .and.popc (csrc/hamming.cu's
    path), m16n8k256 .b1 with .xor.popc (one product a distance, if native)
    and m16n8k32 .s8 (the ±1 int8 product, csrc/bowassign.cu's path).  Each
    form runs a loop of dependent products (one chain: latency) and of 8
    independent chains in 1, 4, 8 and 16 warps of one block and in 132
    blocks of 8 and 16 warps (throughput).  Prints cycles a product a warp
    and products a clock per SM at the SM clock nvidia-smi reads, beside
    the card's name and power limit.  The source is built with nvcc into
    flvis_tpu_torch/_build/."""
    import ctypes

    from flvis_tpu_torch.ops.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = _build.BUILD_DIR / "mma_rates.cu", _build.BUILD_DIR / "libmma_rates.so"
    cu.write_text(MMA_RATES_SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.mma_rates.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = torch.empty(132 * 512, dtype=torch.int32, device="cuda")
    mhz = sm_clock_mhz()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f"gpu: {smi}; SM clock {mhz:.0f} MHz (clocks.max.sm)")
    iters = 2000
    for kind, name in MMA_FORMS:
        for n_chains, blocks, threads in MMA_SHAPES:
            if lib.mma_rates(kind, n_chains, blocks, threads, 10, out.data_ptr()):
                raise RuntimeError(f"{name}: launch failed")
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            lib.mma_rates(kind, n_chains, blocks, threads, iters, out.data_ptr())
            e1.record()
            e1.synchronize()
            cycles = e0.elapsed_time(e1) * 1e-3 * mhz * 1e6
            per_sm = iters * n_chains * (threads // 32) / cycles
            print(f"{name}: {n_chains} chain(s) a warp, {blocks} block(s) of {threads // 32} "
                  f"warps: {cycles / (iters * n_chains):.1f} cycles a product a warp, "
                  f"{per_sm:.3f} products a clock per SM")
    return 0


# ---------------------------------------------------------------------------
# Phase d: the long run (tests/test_longrun.py:55-160's scenario through the
# port's loop node) and the banded PGO's own checks.

LONG_KF, LONG_LEG, LONG_STEP, LONG_DRIFT, LONG_CHUNK = 1100, 200, 0.02, 2e-3, 32


def long_run_inputs(device):
    """The long run's loop configuration, camera, renders and poses: 1,100
    keyframes at 160×120 on a triangle wave of 4 m legs over one plane at
    4 m (fx 160, baseline 0.2), odometry drifting 2 mm a keyframe."""
    from flvis_tpu_torch.config import LoopConfig
    from flvis_tpu_torch.geometry import camera
    from flvis_tpu_torch.io.synthetic import PlanarScene, SceneConfig

    scfg = SceneConfig(width=160, height=120, fx=160.0, fy=160.0, cx=80.0, cy=60.0,
                       baseline=0.2)
    scene = PlanarScene(scfg, plane_depth=4.0, seed=7)
    cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline, width=scfg.width,
                      height=scfg.height, device=device)
    cfg = LoopConfig(max_keyframes=128, num_orb_features=64, vocab_words=128,
                     vocab_refresh_at=64, kf_start=60, kf_dist=50, search_window=5000,
                     kf_max_dist=50, nkf_closest=2, min_pts=12, min_score=0.03,
                     ratio_ransac=0.3, ransac_hypotheses=64, pgo_iters=100)

    def x_of(k):
        phase = k % (2 * LONG_LEG)
        return LONG_STEP * (phase if phase <= LONG_LEG else 2 * LONG_LEG - phase)

    keys = [round(x_of(k) / LONG_STEP) for k in range(LONG_KF)]
    renders = {key: scene.render(np.eye(3), np.asarray([-key * LONG_STEP, 0.0, 0.0]))
               for key in sorted(set(keys))}
    gt_t = np.asarray([[-x_of(k), 0.0, 0.0] for k in range(LONG_KF)], np.float32)
    odo_t = gt_t + np.asarray([[0.0, -LONG_DRIFT * k, 0.0] for k in range(LONG_KF)], np.float32)
    return cfg, cam, renders, keys, gt_t, odo_t


def count_thomas(timer) -> list:
    """Count pose_graph._thomas_solve's calls — one Thomas pass a banded LM
    iteration — into the returned one-item list, until timer.restore()."""
    from flvis_tpu_torch.loop import pose_graph

    iters = [0]
    real = pose_graph._thomas_solve

    def thomas(*a):
        iters[0] += 1
        return real(*a)

    timer.patch(pose_graph, "_thomas_solve", thomas)
    return iters


def record_pgo_routes(timer):
    """Time every pose_graph.optimize (dense) and optimize_banded call, synced
    (route, n_pad, ms, LM iterations of a banded call), and keep every
    call's arguments and result, until timer.restore()."""
    from flvis_tpu_torch.loop import pose_graph

    calls = {"dense": [], "banded": []}
    iters = count_thomas(timer)

    def route(name, real):
        def run(graph, fixed, **kw):
            torch.cuda.synchronize()
            t0, i0 = time.perf_counter(), iters[0]
            out = real(graph, fixed, **kw)
            torch.cuda.synchronize()
            calls[name].append({"n_pad": graph.num_nodes, "ms": 1000.0 * (time.perf_counter() - t0),
                                "iterations": iters[0] - i0, "args": (graph, fixed, kw),
                                "out": out})
            return out
        return run

    timer.patch(pose_graph, "optimize", route("dense", pose_graph.optimize))
    timer.patch(pose_graph, "optimize_banded", route("banded", pose_graph.optimize_banded))
    return calls


def band_graph(node_q, node_t, band_src, loop_src, n, loops, device, n_succ=5, loop_pad=8):
    """A pose graph shaped like loop_closing._build_graph's output over K =
    len(node_q) nodes, the first n valid: the n_succ·K sequential edges
    first (weights 1/s, measured on band_src's poses), then a bucket of
    loop_pad loop edges (weight 5, measured on loop_src's; the unused ones
    invalid), as tests/test_pose_graph.py builds its graphs.  Poses are
    (q (K, 4), t (K, 3)) numpy arrays."""
    from flvis_tpu_torch.geometry import se3
    from flvis_tpu_torch.loop import pose_graph

    K = len(node_q)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)

    def rel(src, i, j):
        T = se3.SE3(f32(src[0]), f32(src[1]))
        return se3.compose(se3.inverse(se3.SE3(T.q[i], T.t[i])), se3.SE3(T.q[j], T.t[j]))

    a = np.arange(K)
    bi = np.concatenate([a] * n_succ)
    bj = np.concatenate([np.minimum(a + s, K - 1) for s in range(1, n_succ + 1)])
    li, lj = np.zeros(loop_pad, np.int64), np.zeros(loop_pad, np.int64)
    for e, (i, j) in enumerate(loops):
        li[e], lj[e] = i, j
    band, loop = rel(band_src, i64(bi), i64(bj)), rel(loop_src, i64(li), i64(lj))
    lv = np.arange(loop_pad) < len(loops)
    loop_q = torch.where(f32(lv)[:, None] > 0, loop.q, f32([[1.0, 0, 0, 0]]))
    loop_t = torch.where(f32(lv)[:, None] > 0, loop.t, 0.0)
    valid = np.concatenate([a + s < n for s in range(1, n_succ + 1)] + [lv])
    w = np.concatenate([np.full(K, 1.0 / s) for s in range(1, n_succ + 1)]
                       + [np.full(loop_pad, 5.0)])
    g = pose_graph.PoseGraph(
        node_q=f32(node_q), node_t=f32(node_t), node_valid=i64(a < n).bool(),
        edge_i=i64(np.concatenate([bi, li])), edge_j=i64(np.concatenate([bj, lj])),
        edge_q=torch.cat([band.q, loop_q]), edge_t=torch.cat([band.t, loop_t]),
        edge_valid=i64(valid).bool(), edge_weight=f32(w))
    return g, n_succ * K


def reference_style_graph(device, K=64, n=50, loops=((0, 45), (3, 47)), noise=0.05, seed=0):
    """tests/test_pose_graph.py:_reference_style_graph: a ring of n of K
    nodes at identity rotations, nodes noisy, edges true."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n)
    q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (K, 1))
    t = np.zeros((K, 3), np.float32)
    t[:n] = 5.0 * np.stack([np.cos(th), np.sin(th), 0 * th], -1)
    noisy = t + rng.normal(0, noise, t.shape).astype(np.float32) * (np.arange(K) < n)[:, None]
    return band_graph(q, noisy, (q, t), (q, t), n, loops, device, loop_pad=16)


def cold_drifted_ring(device, K=2048, n=2000, yaw_drift=5e-5, t_drift=6e-4):
    """tests/test_pose_graph.py:_cold_drifted_ring: a 126 m ring whose
    odometry drifts (yaw and forward bias a step), nodes at the drifted
    odometry, one loop edge (0, n − 10) carrying the whole drift.  Returns
    (graph, band_edges, ground-truth t (K, 3), the drift at node n − 10)."""
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pos_gt = np.stack([20.0 * np.cos(th), 20.0 * np.sin(th), 0 * th], -1)
    yaw_gt = th + np.pi / 2
    yaw_d, pos_d = np.zeros(n), np.zeros((n, 3))
    yaw_d[0], pos_d[0] = yaw_gt[0], pos_gt[0]
    for i in range(n - 1):
        c, s = np.cos(yaw_d[i] - yaw_gt[i]), np.sin(yaw_d[i] - yaw_gt[i])
        Rz = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        pos_d[i + 1] = pos_d[i] + Rz @ (pos_gt[i + 1] - pos_gt[i]) + t_drift * np.asarray(
            [np.cos(yaw_d[i]), np.sin(yaw_d[i]), 0.0])
        yaw_d[i + 1] = yaw_d[i] + (yaw_gt[i + 1] - yaw_gt[i]) + yaw_drift

    def padded(yaw, pos):
        q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (K, 1))
        t = np.zeros((K, 3), np.float32)
        q[:n] = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
        t[:n] = pos
        return q, t

    drifted, truth = padded(yaw_d, pos_d), padded(yaw_gt, pos_gt)
    g, band_edges = band_graph(*drifted, drifted, truth, n, [(0, n - 10)], device)
    return g, band_edges, truth[1], float(np.linalg.norm(pos_d[n - 10] - pos_gt[n - 10]))


def check_banded_solver(device) -> None:
    """The banded PGO's card checks beside the long run: banded against dense
    at K = 64 within tests/test_pose_graph.py's 2e-5, and the cold 2,048-node
    ring at 20 LM iterations against 100 within its bounds (cost ≤ 1.05×,
    max |Δt| < 0.01 m, node 1,990's error < 0.3 × the drift)."""
    from flvis_tpu_torch.loop import pose_graph

    g, be = reference_style_graph(device)
    fixed = torch.zeros(64, dtype=torch.bool, device=device)
    fixed[0] = True
    gd, _ = pose_graph.optimize(g, fixed, iters=25)
    gb, _ = pose_graph.optimize_banded(g, fixed, band_edges=be, iters=25)
    d = max(float((gb.node_t[:50] - gd.node_t[:50]).abs().max()),
            float((gb.node_q[:50] - gd.node_q[:50]).abs().max()))
    print(f"banded vs dense PGO at K = 64 (25 LM steps): max |Δ| {d:.3e} (bound 2e-5) [{SMI}]")
    if not d < 2e-5:
        fail(f"banded and dense PGO differ by {d} at K = 64")
    g, be, t_gt, drift = cold_drifted_ring(device)
    fixed = torch.zeros(2048, dtype=torch.bool, device=device)
    fixed[0] = True
    res = {}
    for it in (20, 100):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[it] = pose_graph.optimize_banded(g, fixed, band_edges=be, iters=it)
        torch.cuda.synchronize()
        res[it] += (1000.0 * (time.perf_counter() - t0),)
    (g20, c20, ms20), (g100, c100, ms100) = res[20], res[100]
    c20, c100 = float(c20), float(c100)
    dmax = float(torch.linalg.vector_norm(g20.node_t[:2000] - g100.node_t[:2000], dim=-1).max())
    err20 = float(np.linalg.norm(g20.node_t[1990].cpu().numpy() - t_gt[1990]))
    print(f"cold 2,048-node ring (drift {drift:.3f} m at node 1,990, one loop edge): 20 LM "
          f"iterations cost {c20:.4f} in {ms20:.1f} ms, 100 cost {c100:.4f} in {ms100:.1f} ms; "
          f"max |Δt| {dmax:.5f} m (bound 0.01); node 1,990 error {err20:.4f} m (bound "
          f"{0.3 * drift:.4f}) [{SMI}]")
    if not (drift > 1.0 and c20 <= 1.05 * c100 + 1e-6 and dmax < 0.01 and err20 < 0.3 * drift):
        fail("the cold 2,048-node ring at 20 LM iterations is outside the 100-iteration bounds")


def run_long(device) -> dict:
    """Phase d: tests/test_longrun.py's 1,100 keyframes through the port's
    LoopCloser in chunks of 32 (add_keyframes_batch, detect_loops_batch,
    optimize_graph), held to that test's assertions; PGO ms per call by
    route and n_pad; the last banded PGO twice more, bit-equal; host syncs
    per banded LM iteration; then check_banded_solver."""
    from flvis_tpu_torch.loop import loop_closing

    cfg, cam, renders, keys, gt_t, odo_t = long_run_inputs(device)
    lc = loop_closing.LoopCloser(cfg, cam, device=device)
    timer = StageTimer()
    pgo = record_pgo_routes(timer)
    timer.wrap(lc, "add_keyframes_batch", "loop ingest")
    timer.wrap(lc, "detect_loops_batch", "loop gate + verify")
    reset_counts()
    t0 = time.perf_counter()
    for c0 in range(0, LONG_KF, LONG_CHUNK):
        ks_range = list(range(c0, min(c0 + LONG_CHUNK, LONG_KF)))
        il = np.stack([renders[keys[k]][0] for k in ks_range]).astype(np.float32)
        ir = np.stack([renders[keys[k]][1] for k in ks_range]).astype(np.float32)
        q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (len(il), 1))
        ks = lc.add_keyframes_batch(il, ir, list(range(len(il))), q, odo_t[ks_range], ks_range)
        if lc.detect_loops_batch(ks):
            lc.optimize_graph()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    timer.restore()

    i0 = min(c.kf_i for c in lc.closures) if lc.closures else 0
    j1 = max(c.kf_j for c in lc.closures) if lc.closures else 0
    spans = [c.kf_j - c.kf_i for c in lc.closures]
    sel = np.arange(i0, LONG_KF)
    err_odo = float(np.linalg.norm(odo_t[sel] - gt_t[sel], axis=-1).mean())
    # kf_t holds T_w_c translations, the camera centres; gt_t and odo_t are
    # T_c_w translations with R = I, whose centres are −t.
    err_node = float(np.linalg.norm(lc.kf_t[i0:LONG_KF].cpu().numpy() + gt_t[sel],
                                    axis=-1).mean())
    drift_t = float(torch.linalg.vector_norm(lc.T_map_odom.t))
    by_route = {}
    for name, cs in pgo.items():
        for c in cs:
            by_route.setdefault((name, c["n_pad"]), []).append(c)
    print(f"long run: {lc.count} keyframes in {wall:.1f} s, store {lc.bow_db.shape[0]} rows, "
          f"vocabulary next refresh at {lc._next_vocab_refresh}, {len(lc.closures)} closures "
          f"(widest span {max(spans, default=0)}), loop window [{i0}, {j1}] = {j1 - i0 + 1} "
          f"keyframes; node error {err_node:.4f} m against odometry {err_odo:.4f} m; "
          f"|T_map_odom.t| {drift_t:.4f} m [{SMI}]")
    print("long run PGO, synced ms per call by route and n_pad (calls, LM iterations a call): "
          + ", ".join(f"{r} {n}: {statistics.mean(c['ms'] for c in cs):.1f} ({len(cs)}"
                      + (f", {statistics.mean(c['iterations'] for c in cs):.1f}" if r == "banded"
                         else "") + ")"
                      for (r, n), cs in sorted(by_route.items()))
          + f"; banded calls {len(pgo['banded'])} [{SMI}]")
    print(f"long run stages, synced ms per call: "
          + ", ".join(f"{k} {v / timer.calls[k]:.1f} x{timer.calls[k]}"
                      for k, v in timer.ms.items()) + f"; launches {launches}")
    ok = (lc.count == LONG_KF and lc.bow_db.shape[0] >= 2048 and lc._next_vocab_refresh > 1024
          and lc._in_run_vocab and len(lc.closures) >= 3 and j1 - i0 + 1 > 256
          and max(spans) >= 2 * LONG_LEG - 60 and err_node < 0.2 * err_odo and drift_t > 0.5)
    if not ok:
        fail("long run: the assertions of tests/test_longrun.py do not hold")
    if not pgo["banded"]:
        fail("long run: no PGO took the banded solver")
    for name in ("fastblur", "sweep", "bowassign", "hamming", "gather"):
        if launches[name] < 1:
            fail(f"long run: {name} never launched")

    # The last banded PGO twice more, and its host syncs per LM iteration.
    from flvis_tpu_torch.loop import pose_graph

    last = pgo["banded"][-1]
    graph, fixed, kw = last["args"]
    ref, ref_cost = last["out"]
    again = [pose_graph.optimize_banded(graph, fixed, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(g.node_q, ref.node_q) and torch.equal(g.node_t, ref.node_t)
               and torch.equal(c, ref_cost) for g, c in again)
    n_it = count_thomas(timer)
    syncs = host_syncs(lambda: pose_graph.optimize_banded(graph, fixed, **kw))
    timer.restore()
    n_it = n_it[0]
    print(f"banded PGO repeats: the long run's last graph (n_pad {graph.num_nodes}, "
          f"{int(graph.node_valid.sum())} nodes, {int(graph.edge_valid.sum())} edges) optimised "
          f"twice more: {'bit-equal' if same else 'DIFFERENT'}; one call: {syncs} host syncs over "
          f"{n_it} LM iterations ({syncs / max(n_it, 1):.2f} an iteration, the assembly plans' "
          f"reads included) [{SMI}]")
    if not same:
        fail("the banded PGO does not repeat bit for bit on the card")
    check_banded_solver(device)
    return {"launches": launches, "banded_calls": len(pgo["banded"])}


# ---------------------------------------------------------------------------
# Phase e: SlamSystem in RGB-D mode (the reference's VI_TYPE_D435I_DEPTH).

def rgbd_system_config(cfg, scfg, device):
    """The bench's system configuration in depth mode and its RGB-D camera
    (baseline 0, depth_factor 1000: Z16 millimetres)."""
    import dataclasses

    from flvis_tpu_torch.geometry import camera

    cfg = cfg.replace(frontend=dataclasses.replace(cfg.frontend, depth_mode=True))
    cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, 0.0, depth_factor=1000.0,
                      width=scfg.width, height=scfg.height, device=device)
    return cfg, cam


RGBD_SLICE = (0, 16, 24, N_FRAMES)           # capture chunk, profiled chunk, timed chunk
RGBD_VIO = (0, 64, 128, 136, 192, LOOP_FRAMES)


def rgbd_chunks(slam, label, bounds, step, profiled: int):
    """Drive step(a, c) over the chunks of `bounds`, chunk `profiled` under
    device_window; returns (outs, the last chunk's frames/s, the replays'
    launches in the profiled chunk)."""
    outs = []
    for k, (a, c) in enumerate(zip(bounds[:-1], bounds[1:])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if k == profiled:
            c0 = read_counts()
            _, _, _, _, names = device_window(lambda: outs.append(step(a, c)))
            replayed = replay_launches(names, c0)
            continue
        outs.append(step(a, c))
        torch.cuda.synchronize()
        fps = (c - a) / (time.perf_counter() - t0)
    return outs, fps, replayed


def rgbd_launch_checks(label, slam, counted, replayed, names) -> dict:
    """Each kernel of `names` launched on the path (the captured step's
    in-graph kernels in the profiled replays), and sweep never."""
    captured = bool(slam._captured)
    launches = path_launches(counted, replayed, captured)
    print(launch_line(label, counted, replayed, captured, "of the profiled chunk"))
    for k in names:
        if launches[k] < 1:
            fail(f"{label}: {k} never launched")
    if launches["sweep"]:
        fail(f"{label}: sweep launched {launches['sweep']} times in depth mode")
    return launches


def rgbd_systems(cfg, scfg, device, eager: bool):
    """Phase e's two systems in depth mode — the slice's (process_frames)
    and the VIO + loop one's — on their inputs: (a)'s 64-frame orbit and
    (b)'s 256-frame out-and-back, each image with its Z16 depth image.
    Captured, both steps are captured here, before the process's first
    trace (see phase_de); eager, both step through use_eager_chunks."""
    from flvis_tpu_torch.geometry import se3
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    cfg, cam = rgbd_system_config(cfg, scfg, device)
    poses, imgs0, _, depth = orbit_frames(scfg)
    sl_in = (poses, imgs0, depth)
    vio_in = loop_sequence(scfg, depth=True)
    sl = SlamSystem(cfg, cam, device=device, seed=0)
    vio = SlamSystem(cfg, cam, device=device, seed=0, T_i_c=se3.identity(device=device),
                     use_imu=True, use_loop=True)
    for slam, kind, label, (_, imgs0, depth) in ((sl, "stereo", "rgbd slice", sl_in),
                                                 (vio, "vio", "rgbd vio+loop", vio_in[:3])):
        if eager:
            use_eager_chunks(slam)
        else:
            capture_first(slam, kind, label, frame_inputs(device, imgs0, depth, kind))
    return (sl, sl_in), (vio, vio_in)


def run_rgbd_slice(slam, inputs, eager: bool = False) -> dict:
    """Phase e, first half: process_frames in depth mode over (a)'s 64-frame
    orbit, captured or eager (rgbd_systems)."""
    label = "rgbd slice eager" if eager else "rgbd slice"
    poses, imgs0, depth = inputs
    reset_counts()
    outs, fps, replayed = rgbd_chunks(
        slam, label, RGBD_SLICE, lambda a, c: slam.process_frames(imgs0[a:c], depth[a:c]), 1)
    counted = read_counts()
    status = np.concatenate([o.status for o in outs])
    C_est = slam.trajectory_cam_centers()
    C_gt = np.asarray([-R.T @ t for (R, t) in poses])
    err = ate(C_est, C_gt)
    bound_m = 0.02 * 0.02 * N_FRAMES + 0.01        # tests/test_tracker.py:97
    print(f"{label}: {N_FRAMES} frames, {len(slam.keyframes)} keyframes, statuses "
          f"{np.bincount(status)}, ATE {err:.5f} m (bound {bound_m:.5f}); {fps:.2f} frames/s over "
          f"frames {RGBD_SLICE[2]}..{RGBD_SLICE[3] - 1} [{SMI}]")
    graph_report(slam, label)
    launches = rgbd_launch_checks(label, slam, counted, replayed, ("grad_blur", "schur_step"))
    if not np.all(status[1:] == 1):
        fail(f"{label} frames not TRACKING: {np.flatnonzero(status != 1).tolist()}")
    if not (np.isfinite(C_est).all() and err < bound_m):
        fail(f"{label} ATE {err} over bound {bound_m}")
    return {"outs": outs, "costs": list(slam.ba_costs), "fps": fps, "launches": launches}


def run_rgbd_vio(slam, inputs, eager: bool = False) -> dict:
    """Phase e, second half: process_frames_vio with use_loop=True in depth
    mode over (b)'s 256-frame out-and-back, then flush_loop, captured or
    eager (rgbd_systems)."""
    label = "rgbd vio+loop eager" if eager else "rgbd vio+loop"
    poses, imgs0, depth, frame_t, accs, gyros, imuts, path = inputs
    reset_counts()

    def step(a, c):
        sl = slice(a, c)
        return slam.process_frames_vio(imgs0[sl], depth[sl], ts=frame_t[sl], imu_acc=accs[sl],
                                       imu_gyro=gyros[sl], imu_t=imuts[sl])

    outs, fps, replayed = rgbd_chunks(slam, label, RGBD_VIO, step, 2)
    slam.flush_loop()
    torch.cuda.synchronize()
    counted = read_counts()
    lc = slam.loop_closer
    status = np.concatenate([o.status for o in outs])
    C_gt = np.asarray([-R.T @ t for (R, t) in poses])
    C_raw, C_cor = slam.trajectory_cam_centers(), slam.trajectory_cam_centers(loop_corrected=True)
    ate_raw, ate_cor = ate(C_raw, C_gt), ate(C_cor, C_gt)
    bound_m = 0.02 * path + 0.01                       # tests/test_pipeline.py:434-435
    closures = [(c.kf_i, c.kf_j, c.num_inliers) for c in lc.closures]
    print(f"{label}: {LOOP_FRAMES} frames, {len(slam.keyframes)} keyframes, statuses "
          f"{np.bincount(status)}, {len(closures)} closures {closures[:6]}"
          f"{'...' if len(closures) > 6 else ''}; ATE odometry {ate_raw:.5f} m, loop-corrected "
          f"{ate_cor:.5f} m (bound {bound_m:.5f}); {fps:.2f} frames/s over frames "
          f"{RGBD_VIO[4]}..{RGBD_VIO[5] - 1} [{SMI}]")
    graph_report(slam, label)
    launches = rgbd_launch_checks(label, slam, counted, replayed,
                                  ("grad_blur", "schur_step", "imu_chain", "gather", "fastblur",
                                   "bowassign", "hamming"))
    if not np.all(status[1:] == 1):
        fail(f"{label} frames not TRACKING: {np.flatnonzero(status != 1).tolist()}")
    if not closures:
        fail(f"{label} accepted no loop closure")
    if not (np.isfinite(C_cor).all() and ate_raw < bound_m and ate_cor < bound_m):
        fail(f"{label} ATE {ate_raw} / {ate_cor} over bound {bound_m}")
    return {"outs": outs, "costs": list(slam.ba_costs), "fps": fps, "launches": launches,
            "closures": closures, "ate": (ate_raw, ate_cor), "C": C_cor, "C_gt": C_gt,
            "ts": np.asarray(frame_t), "slam": slam}


def check_trajectory_files(r) -> None:
    """Phase e's trajectory through io/trajectory (TUM and KITTI), read back
    equal within the files' printed digits, and utils/evaluation.ate_rmse
    against the phase's own ATE within 1e-6."""
    import tempfile

    from flvis_tpu_torch.geometry import se3, so3
    from flvis_tpu_torch.io import trajectory
    from flvis_tpu_torch.utils import evaluation

    slam, C = r["slam"], r["C"]
    q_cw = torch.as_tensor(np.stack([q for (_, _, q, _) in slam.trajectory]))
    t_cw = torch.as_tensor(np.stack([t for (_, _, _, t) in slam.trajectory]))
    T_wc = se3.inverse(se3.SE3(q_cw, t_cw))
    poses = np.tile(np.eye(4), (len(C), 1, 1))
    poses[:, :3, :3] = so3.to_matrix(T_wc.q).numpy()
    poses[:, :3, 3] = C
    with tempfile.TemporaryDirectory() as d:
        trajectory.write_tum(f"{d}/e.tum", r["ts"], C, q_cw.numpy())
        trajectory.write_kitti(f"{d}/e.kitti", poses)
        ts, C_back, q_back = trajectory.read_tum(f"{d}/e.tum")
        P_back = trajectory.read_kitti(f"{d}/e.kitti")
    d_tum = max(float(np.abs(C_back - C).max()), float(np.abs(q_back - q_cw.numpy()).max()))
    d_kitti = float(np.abs(P_back - poses).max())
    ate_e, _ = evaluation.ate_rmse(C, r["C_gt"], align=False)
    ate_phase = r["ate"][-1] if isinstance(r["ate"], tuple) else r["ate"]
    print(f"rgbd trajectory files: TUM read back within {d_tum:.2e} (6 decimals), KITTI within "
          f"{d_kitti:.2e} (7 digits); utils.evaluation.ate_rmse {ate_e:.7f} m against the "
          f"phase's {ate_phase:.7f} m")
    if not (d_tum <= 5.1e-7 and d_kitti <= 1e-5 and len(ts) == len(C)
            and abs(ate_e - ate_phase) < 1e-6):
        fail("rgbd: the trajectory files or evaluation.ate_rmse disagree with the run")


def run_euroc_format(device) -> str:
    """If cv2 imports: tests/test_pipeline.py:314-368's synthetic
    EuRoC-format sequence (16 frames, seed 6) through the port's
    EurocDataset and process_frames_vio (chunks of 8), ATE < 0.02 m.
    Returns what ran."""
    import tempfile

    try:
        import cv2
    except ImportError as e:
        return f"cv2 does not import ({e}): the EuRoC-format run was not made"
    from flvis_tpu_torch.config import BackendConfig, FrontendConfig, SystemConfig
    from flvis_tpu_torch.io.euroc import EurocDataset
    from flvis_tpu_torch.io.synthetic import export_euroc_sequence
    from flvis_tpu_torch.pipeline.runner import SlamSystem
    from flvis_tpu_torch.utils import evaluation

    with tempfile.TemporaryDirectory() as d:
        export_euroc_sequence(d, num_frames=16, seed=6)
        ds = EurocDataset(d, device=device)
        frames = list(ds.frames())
    cam = ds.camera
    cfg = SystemConfig(
        frontend=FrontendConfig(width=cam.width, height=cam.height, num_slots=128,
                                pyramid_levels=3, per_cell=8, min_distance=12.0, margin=22),
        backend=BackendConfig(window_size=5, max_landmarks=256, iters1=6, iters2=3))
    slam = SlamSystem(cfg, cam, device=device, T_i_c=ds.T_i_c, use_imu=True)
    for c0 in range(0, len(frames), 8):
        b = frames[c0:c0 + 8]
        slam.process_frames_vio(np.stack([f.img0 for f in b]), np.stack([f.img1 for f in b]),
                                ts=np.asarray([f.t for f in b]), imu_acc=[f.imu_acc for f in b],
                                imu_gyro=[f.imu_gyro for f in b], imu_t=[f.imu_t for f in b])
    ts = np.asarray([t for (_, t, _, _) in slam.trajectory])
    ia, ib = evaluation.associate(ts, ds.gt_t)
    rmse, _ = evaluation.ate_rmse(slam.trajectory_cam_centers()[ia], ds.gt_pos[ib])
    msg = (f"cv2 {cv2.__version__} imports and decodes PNG: the EuRoC-format sequence (16 "
           f"frames, {cam.width}x{cam.height}) through EurocDataset and process_frames_vio, ATE "
           f"{rmse:.5f} m over {len(ia)} poses (bound 0.02)")
    if not (len(ia) == len(frames) and rmse < 0.02):
        fail(f"euroc-format run: {msg}")
    return msg


def run_rgbd(cfg, scfg, device) -> dict:
    """Phase e: the RGB-D slice and VIO + loop runs, each captured then
    eager on the same frames and draws and compared bit for bit (closures
    and ATE too), the trajectory files, and the EuRoC-format run."""
    (sl, sl_in), (vio, vio_in) = rgbd_systems(cfg, scfg, device, eager=False)
    sl_r, vio_r = run_rgbd_slice(sl, sl_in), run_rgbd_vio(vio, vio_in)
    (sl, sl_in), (vio, vio_in) = rgbd_systems(cfg, scfg, device, eager=True)
    sl_e, vio_e = run_rgbd_slice(sl, sl_in, eager=True), run_rgbd_vio(vio, vio_in, eager=True)
    compare_runs("rgbd slice", sl_r, sl_e)
    compare_runs("rgbd vio+loop", vio_r, vio_e)
    same = vio_r["closures"] == vio_e["closures"] and vio_r["ate"] == vio_e["ate"]
    print(f"rgbd vio+loop: captured vs eager closures and ATE "
          f"{'equal' if same else 'DIFFERENT'}: {len(vio_r['closures'])} / "
          f"{len(vio_e['closures'])} closures, ATE {vio_r['ate']} / {vio_e['ate']}")
    if not same:
        fail("rgbd vio+loop: the captured and the eager run closed other loops or another ATE")
    print(f"phase e captured vs eager, same call: frames/s slice {sl_r['fps']:.2f} vs "
          f"{sl_e['fps']:.2f}, vio+loop {vio_r['fps']:.2f} vs {vio_e['fps']:.2f} (the last "
          f"chunk of each) [{SMI}]")
    check_trajectory_files(vio_r)
    print(f"phase e EuRoC format: {run_euroc_format(device)}")
    return {k: vio_r["launches"][k] + sl_r["launches"][k] for k in vio_r["launches"]}


def phase_de() -> int:
    """--phase-de: phases e then d in a process of their own, e's two steps
    captured before the process's first trace (as phase c's: see
    phase_c); the last line of output is a JSON object of their
    launches."""
    from flvis_tpu_torch.ops.kernels import _build

    global SMI
    SMI = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    device = torch.device("cuda", 0)
    _build.load_library()
    cfg, scfg = system_config()
    t0 = time.perf_counter()
    e = run_rgbd(cfg, scfg, device)
    print(f"phase e, RGB-D, captured and eager: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    d = run_long(device)
    print(f"phase d, the long run and the banded PGO: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"e": e, "d": d}))
    return 0


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--phase-of"] and len(args) == 3 and args[2] in ("b", "c"):
        return run_phase_of(args[1], args[2])
    if args == ["--phase-c"]:
        return phase_c()
    if args == ["--phase-de"]:
        return phase_de()
    if args and not (args[:1] == ["--parent"] and len(args) == 2 or args == ["--mma-rates"]):
        print("usage: python3 chip_smoke.py [--parent DIR | --mma-rates | --phase-c | --phase-de]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if args == ["--mma-rates"]:
        return mma_rates()
    import os
    import tempfile

    from flvis_tpu_torch.ops import orb
    from flvis_tpu_torch.ops.kernels import _build

    # Removed when the process ends, however it ends.
    renders = tempfile.TemporaryDirectory(prefix="chip_smoke_renders_")
    os.environ[RENDERS] = renders.name
    device = torch.device("cuda", 0)
    global SMI
    smi = SMI = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"gpu: {smi}")

    t0 = time.perf_counter()
    _, info = _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {info['build_s']:.2f} s) "
          f"-> {info['path']}")
    fn = ""
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {fn[:64]}: {line.strip()}")

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
             check_hamming(desc_l.contiguous(), desc_r.contiguous(), kf_desc, kf_valid),
             check_bowassign(kf_desc, kf_valid, cfg), check_gather(img_l, cfg, device)]
    feed_readings(device)
    print(f"phase kernel checks: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    slice_r = run_slice(cfg, scfg, cam, device)
    slice_e = run_slice(cfg, scfg, cam, device, eager=True)
    compare_runs("slice", slice_r, slice_e)
    print(f"phase a, stereo slice, captured and eager: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_rare_branches(cfg, scfg, cam, device)
    print(f"rare branches: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    head_r = run_headline(cfg, scfg, cam, device)
    head_e = run_headline(cfg, scfg, cam, device, eager=True)
    compare_runs("headline", head_r, head_e)
    same = head_r["closures"] == head_e["closures"] and head_r["ate"] == head_e["ate"]
    print(f"headline: captured vs eager closures (i, j, n_match, n_inl) and ATE "
          f"{'equal' if same else 'DIFFERENT'}: {len(head_r['closures'])} / "
          f"{len(head_e['closures'])} closures, ATE {head_r['ate']} / {head_e['ate']}")
    if not same:
        fail("headline: the captured and the eager run closed other loops or another ATE")
    print(f"phase b, headline, captured and eager: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_r = run_own_process("--phase-c")
    print(f"phase c, multi-sequence, captured and eager (its own process): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    de = run_own_process("--phase-de")
    print(f"phases e and d, RGB-D and the long run (their own process): "
          f"{time.perf_counter() - t0:.1f} s")
    for ph, r, e in (("a", slice_r, slice_e), ("b", head_r, head_e)):
        g = next(iter(r["graph"].values()))
        print(f"phase {ph} captured vs eager, same call: frames/s {r['fps']:.2f} vs "
              f"{e['fps']:.2f} ({r['fps'] / e['fps']:.2f}x); device busy {r['busy']:.3f} vs "
              f"{e['busy']:.3f}; host syncs a frame in a chunk's step {r['syncs_per_frame']:.2f} "
              f"vs {e['syncs_per_frame']:.2f}; device kernel events a frame "
              f"{r['events_per_frame']:.0f} vs {e['events_per_frame']:.0f}; a replay "
              f"{g['kernel_nodes']:.1f} graph kernel nodes, {g['if_bodies']:.2f} IF bodies and "
              f"{g['while_iterations']:.2f} WHILE iterations; "
              f"capture {g['warmup']:.2f} s warm-up + {g['capture']:.2f} s [{SMI}]")
    ms_launches = ms_r["launches"]
    if args:
        compare_with_parent(args[1], {"b": head_r["verify"], "c": ms_r["verify"]})
    slice_launches, head_launches = slice_r["launches"], head_r["launches"]

    # Launches on the path each kernel belongs to: the slice for rows 1-2,
    # the headline for 3-6, the multi-sequence composition for 7-8.
    for e in table:
        path_counts = {"grad_blur": slice_launches, "schur_step": slice_launches,
                       "bowassign": ms_launches, "gather": ms_launches}.get(e["name"],
                                                                            head_launches)
        e["launches"] = path_counts[e["name"]]
    print(f"launches in phase e (RGB-D, captured: its wrappers and profiled replays): "
          f"{de['e']}; in phase d (the long run): {de['d']['launches']}, "
          f"{de['d']['banded_calls']} banded PGO calls")
    print(json.dumps({"kernels": table}))
    print(f"chip_smoke: {time.perf_counter() - T_START:.0f} s in all")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
