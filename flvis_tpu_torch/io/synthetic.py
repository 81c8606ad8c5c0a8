"""Copy of flvis_tpu/io/synthetic.py (the port keeps its own; it imports nothing of flvis_tpu).

Synthetic scenes for testing and benchmarking.

The reference validates only by replaying recorded datasets (EuRoC/KITTI
rosbags — see SURVEY.md §4); it ships no unit or synthetic tests.  This
module provides what the TPU build needs instead: procedurally textured
images with exactly known ground-truth camera trajectories, depth maps and
stereo pairs, so every kernel and the whole pipeline can be verified against
closed-form truth without dataset downloads.

Host-side (numpy) on purpose — data generation is not part of the measured
device pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def textured_image(rng: np.random.Generator, h: int, w: int, octaves: int = 4) -> np.ndarray:
    """Smooth multi-octave random texture in [0, 255], float32 (H, W).

    Enough local gradient structure everywhere for LK and corner detection.
    """
    img = np.zeros((h, w), np.float32)
    for o in range(octaves):
        s = 2 ** (octaves - o)
        small = rng.standard_normal((h // s + 2, w // s + 2)).astype(np.float32)
        # Bilinear upsample.
        ys = np.linspace(0, small.shape[0] - 1.001, h)
        xs = np.linspace(0, small.shape[1] - 1.001, w)
        y0 = ys.astype(int); x0 = xs.astype(int)
        fy = (ys - y0)[:, None]; fx = (xs - x0)[None, :]
        up = (
            small[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + small[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + small[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + small[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        img += up * (2.0 ** o)
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    return img.astype(np.float32)


def warp_translate(img: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Shift an image by a subpixel translation (bilinear, edge clamp)."""
    h, w = img.shape
    xs = np.clip(np.arange(w) - dx, 0, w - 1.001)
    ys = np.clip(np.arange(h) - dy, 0, h - 1.001)
    x0 = xs.astype(int); y0 = ys.astype(int)
    fx = (xs - x0)[None, :]; fy = (ys - y0)[:, None]
    return (
        img[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + img[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
        + img[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
        + img[np.ix_(y0 + 1, x0 + 1)] * fy * fx
    ).astype(np.float32)


@dataclasses.dataclass
class SceneConfig:
    width: int = 512
    height: int = 384
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 256.0
    cy: float = 192.0
    baseline: float = 0.2


class PlanarScene:
    """A textured fronto-parallel world plane viewed by a moving stereo rig.

    The world is the plane z = plane_depth carrying a texture; the camera
    translates/rotates in front of it.  Every pixel has exact closed-form
    depth and correspondence, making it an analytically checkable end-to-end
    scenario (LK flow, triangulated depth, PnP pose, full VO loop).
    """

    def __init__(self, cfg: SceneConfig, plane_depth: float = 8.0, seed: int = 0,
                 texture_scale: float = 4.0):
        self.cfg = cfg
        self.depth = plane_depth
        rng = np.random.default_rng(seed)
        # World-plane texture, sampled at texture_scale px per metre... the
        # texture covers enough plane area for all rendered views.
        self.tex_h = int(cfg.height * texture_scale)
        self.tex_w = int(cfg.width * texture_scale)
        self.tex = textured_image(rng, self.tex_h, self.tex_w)
        # Metres of plane per texture pixel: make the full-res view at the
        # nominal depth sample the texture near 1:1.
        self.m_per_tpx = plane_depth / cfg.fx / 2.0

    def _sample_tex(self, X, Y):
        """Sample the plane texture at world coords (X, Y) (arrays, metres)."""
        u = X / self.m_per_tpx + self.tex_w / 2.0
        v = Y / self.m_per_tpx + self.tex_h / 2.0
        u = np.clip(u, 0, self.tex_w - 1.001)
        v = np.clip(v, 0, self.tex_h - 1.001)
        u0 = u.astype(int); v0 = v.astype(int)
        fu = u - u0; fv = v - v0
        t = self.tex
        return (
            t[v0, u0] * (1 - fv) * (1 - fu)
            + t[v0, u0 + 1] * (1 - fv) * fu
            + t[v0 + 1, u0] * fv * (1 - fu)
            + t[v0 + 1, u0 + 1] * fv * fu
        ).astype(np.float32)

    def render(self, T_c_w_R: np.ndarray, T_c_w_t: np.ndarray):
        """Render (img_left, img_right, depth_left) for camera pose T_c_w.

        T_c_w maps world → camera: x_c = R x_w + t.
        """
        cfg = self.cfg
        R, t = T_c_w_R, T_c_w_t
        Rwc = R.T
        C = -Rwc @ t  # camera centre in world
        us, vs = np.meshgrid(np.arange(cfg.width), np.arange(cfg.height))

        def render_cam(offset_x):
            # Right camera sits at +baseline along camera x.
            C_cam = C + Rwc @ np.array([offset_x, 0.0, 0.0])
            # Ray directions in world for every pixel.
            d_c = np.stack(
                [(us - cfg.cx) / cfg.fx, (vs - cfg.cy) / cfg.fy, np.ones_like(us, np.float32)],
                axis=-1,
            )
            d_w = d_c @ Rwc.T
            # Intersect with plane z = depth.
            dz = d_w[..., 2]
            dz = np.where(np.abs(dz) < 1e-9, 1e-9, dz)
            lam = (self.depth - C_cam[2]) / dz
            X = C_cam[0] + lam * d_w[..., 0]
            Y = C_cam[1] + lam * d_w[..., 1]
            img = self._sample_tex(X, Y)
            # Depth along camera z = lam * d_c_z(=1) rotated... depth is the
            # camera-frame z of the intersection point.
            Pw = np.stack([X, Y, np.full_like(X, self.depth)], axis=-1)
            Pc = (Pw - (C_cam)[None, None, :]) @ Rwc
            return img, Pc[..., 2].astype(np.float32)

        img_l, depth_l = render_cam(0.0)
        img_r, _ = render_cam(cfg.baseline)
        return img_l, img_r, depth_l


def imu_from_trajectory(poses, fps: float, imu_rate: float = 200.0,
                        t0: float = 100.0, gravity: float = 9.81):
    """Trajectory-consistent synthetic IMU: body rates from the relative
    rotation between consecutive poses, accel = R_bw(C'' + g) — the same
    model export_euroc_sequence writes to imu0/data.csv.

    Args:
      poses: list of (R, t) world→camera poses (body ≈ cam, T_i_c = I).
      fps: camera rate; imu_rate: IMU sample rate.
    Returns (imu_t (M,), gyro (M, 3), acc (M, 3), frame_t (N,)).
    """
    num_frames = len(poses)
    centers = np.asarray([-R.T @ t for (R, t) in poses])
    n_imu = int(num_frames / fps * imu_rate)
    t_imu = t0 + np.arange(n_imu) / imu_rate
    tt = t0 + np.arange(num_frames) / fps
    acc_w = np.zeros((n_imu, 3))
    for d in range(3):
        c_i = np.interp(t_imu, tt, centers[:, d])
        acc_w[1:-1, d] = (c_i[2:] - 2 * c_i[1:-1] + c_i[:-2]) * imu_rate ** 2
    from scipy.spatial.transform import Rotation as _Rot

    omegas = np.zeros((num_frames, 3))
    for k in range(num_frames - 1):
        R_rel = poses[k + 1][0] @ poses[k][0].T
        omegas[k] = _Rot.from_matrix(R_rel).as_rotvec() * fps
    gyro = np.zeros((n_imu, 3), np.float32)
    acc = np.zeros((n_imu, 3), np.float32)
    for k in range(n_imu):
        fidx = min(int((t_imu[k] - t0) * fps), num_frames - 1)
        Rk = poses[fidx][0]
        acc[k] = Rk @ (acc_w[k] + np.array([0.0, 0.0, gravity]))
        gyro[k] = omegas[fidx]
    # Timestamps stay float64: the EuRoC exporter writes exact nanosecond
    # CSV values from them (a float32 cast would jitter them by ~8 us).
    return t_imu, gyro, acc, tt


class MultiPlaneScene:
    """Several occluding textured fronto-parallel slabs at different depths.

    The single-plane scene is the depth-degenerate case (planar structure is
    the classic ambiguous configuration for epipolar geometry, and uniform
    depth gives the motion BA its shallowest rotation/translation valley).
    This scene ray-casts 2-4 finite slabs at staggered depths with a far
    background plane, so stereo disparity spans a real range and occlusion
    boundaries exist — closer to KITTI/EuRoC structure while keeping exact
    closed-form depth and correspondence.
    """

    def __init__(self, cfg: SceneConfig, depths=(4.0, 7.0, 12.0), seed: int = 0,
                 texture_scale: float = 4.0):
        self.cfg = cfg
        self.depths = sorted(depths)          # near → far; last = background
        self.tex_h = int(cfg.height * texture_scale)
        self.tex_w = int(cfg.width * texture_scale)
        self.texs = [textured_image(np.random.default_rng(seed + 7 * k),
                                    self.tex_h, self.tex_w)
                     for k in range(len(self.depths))]
        self.m_per_tpx = self.depths[-1] / cfg.fx / 2.0
        # Finite X-extents per slab (metres, world): staggered vertical bands;
        # the farthest plane is infinite (background).
        w_m = cfg.width / cfg.fx * self.depths[-1]
        n = len(self.depths)
        self.extents = []
        for k in range(n - 1):
            x0 = -w_m / 2 + (k + 0.15) * w_m / n
            self.extents.append((x0, x0 + 0.55 * w_m / n * 2))
        self.extents.append((-np.inf, np.inf))

    def _sample_tex(self, k, X, Y):
        u = np.clip(X / self.m_per_tpx + self.tex_w / 2.0, 0, self.tex_w - 1.001)
        v = np.clip(Y / self.m_per_tpx + self.tex_h / 2.0, 0, self.tex_h - 1.001)
        u0 = u.astype(int); v0 = v.astype(int)
        fu = u - u0; fv = v - v0
        t = self.texs[k]
        return (t[v0, u0] * (1 - fv) * (1 - fu) + t[v0, u0 + 1] * (1 - fv) * fu
                + t[v0 + 1, u0] * fv * (1 - fu)
                + t[v0 + 1, u0 + 1] * fv * fu).astype(np.float32)

    def render(self, T_c_w_R: np.ndarray, T_c_w_t: np.ndarray):
        """(img_left, img_right, depth_left) for camera pose T_c_w."""
        cfg = self.cfg
        Rwc = T_c_w_R.T
        C = -Rwc @ T_c_w_t
        us, vs = np.meshgrid(np.arange(cfg.width), np.arange(cfg.height))

        def render_cam(offset_x):
            C_cam = C + Rwc @ np.array([offset_x, 0.0, 0.0])
            d_c = np.stack([(us - cfg.cx) / cfg.fx, (vs - cfg.cy) / cfg.fy,
                            np.ones_like(us, np.float32)], axis=-1)
            d_w = d_c @ Rwc.T
            dz = np.where(np.abs(d_w[..., 2]) < 1e-9, 1e-9, d_w[..., 2])
            img = np.zeros((cfg.height, cfg.width), np.float32)
            zbuf = np.full((cfg.height, cfg.width), np.inf, np.float32)
            for k, zk in enumerate(self.depths):
                lam = (zk - C_cam[2]) / dz
                X = C_cam[0] + lam * d_w[..., 0]
                Y = C_cam[1] + lam * d_w[..., 1]
                x0, x1 = self.extents[k]
                hit = (lam > 0) & (X >= x0) & (X <= x1) & (lam < zbuf)
                if not hit.any():
                    continue
                img = np.where(hit, self._sample_tex(k, X, Y), img)
                zbuf = np.where(hit, lam, zbuf)
            # Camera-frame z of the hit point (rays have unit z in cam frame,
            # so depth along camera z = lam * (R_cw d_w)_z = lam * d_c_z = lam).
            return img, np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)

        img_l, depth_l = render_cam(0.0)
        img_r, _ = render_cam(cfg.baseline)
        return img_l, img_r, depth_l


def export_euroc_sequence(outdir, num_frames: int = 30, fps: float = 20.0,
                          imu_rate: float = 200.0, seed: int = 0,
                          plane_depth: float = 8.0, step: float = 0.03):
    """Render a synthetic scene into an EuRoC/ASL directory tree.

    Produces mav0/{cam0,cam1}/{sensor.yaml,data.csv,data/*.png},
    mav0/imu0/data.csv (gravity + finite-difference accelerations consistent
    with the camera path) and ground truth — so the EuRoC driver, the full
    pipeline and the evaluation can be exercised end-to-end without
    downloading a real dataset.
    """
    import os

    import cv2
    import yaml

    cfg = SceneConfig()
    scene = PlanarScene(cfg, plane_depth=plane_depth, seed=seed)
    poses = orbit_trajectory(num_frames, step=step)
    mav = os.path.join(outdir, "mav0")

    for cam, off in [("cam0", 0.0), ("cam1", cfg.baseline)]:
        os.makedirs(os.path.join(mav, cam, "data"), exist_ok=True)
        T = np.eye(4)
        T[0, 3] = off
        sensor = {
            "T_BS": {"data": T.reshape(-1).tolist()},
            "intrinsics": [cfg.fx, cfg.fy, cfg.cx, cfg.cy],
            "distortion_coefficients": [0.0, 0.0, 0.0, 0.0],
            "resolution": [cfg.width, cfg.height],
        }
        with open(os.path.join(mav, cam, "sensor.yaml"), "w") as f:
            yaml.dump(sensor, f)

    t0 = 100.0
    ts_ns = []
    centers = []
    for i, (R, t) in enumerate(poses):
        img_l, img_r, _ = scene.render(R, t)
        ts = int(1e9 * (t0 + i / fps))
        ts_ns.append(ts)
        centers.append(-R.T @ t)
        cv2.imwrite(os.path.join(mav, "cam0", "data", f"{ts}.png"),
                    img_l.astype(np.uint8))
        cv2.imwrite(os.path.join(mav, "cam1", "data", f"{ts}.png"),
                    img_r.astype(np.uint8))
    for cam in ["cam0", "cam1"]:
        with open(os.path.join(mav, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for ts in ts_ns:
                f.write(f"{ts},{ts}.png\n")

    # IMU consistent with the rendered trajectory: body rates from the
    # relative rotation between consecutive poses, accel = R_bw(C'' - g).
    centers = np.asarray(centers)
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    t_imu, gyro, acc, _ = imu_from_trajectory(poses, fps, imu_rate, t0)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for k in range(len(t_imu)):
            w, a = gyro[k], acc[k]
            f.write(f"{int(1e9 * t_imu[k])},{w[0]:.6f},{w[1]:.6f},{w[2]:.6f},"
                    f"{a[0]:.6f},{a[1]:.6f},{a[2]:.6f}\n")

    gdir = os.path.join(mav, "state_groundtruth_estimate0")
    os.makedirs(gdir, exist_ok=True)
    with open(os.path.join(gdir, "data.csv"), "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
        for ts, C in zip(ts_ns, centers):
            f.write(f"{ts},{C[0]:.6f},{C[1]:.6f},{C[2]:.6f},1,0,0,0\n")
    return outdir


def export_kitti_sequence(outdir, num_frames: int = 30, seed: int = 0,
                          plane_depth: float = 8.0, step: float = 0.03):
    """Render a synthetic scene into a KITTI odometry sequence directory
    (image_0/, image_1/, calib.txt, times.txt, poses.txt) so the KITTI
    driver + native loader + evaluation run end-to-end without data."""
    import os

    import cv2

    cfg = SceneConfig()
    scene = PlanarScene(cfg, plane_depth=plane_depth, seed=seed)
    poses = orbit_trajectory(num_frames, step=step)
    os.makedirs(os.path.join(outdir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "image_1"), exist_ok=True)
    with open(os.path.join(outdir, "calib.txt"), "w") as f:
        f.write(f"P0: {cfg.fx} 0 {cfg.cx} 0 0 {cfg.fy} {cfg.cy} 0 0 0 1 0\n")
        f.write(f"P1: {cfg.fx} 0 {cfg.cx} {-cfg.fx * cfg.baseline} 0 {cfg.fy} "
                f"{cfg.cy} 0 0 0 1 0\n")
    np.savetxt(os.path.join(outdir, "times.txt"), 0.1 * np.arange(num_frames))
    gt = []
    for i, (R, t) in enumerate(poses):
        img_l, img_r, _ = scene.render(R, t)
        cv2.imwrite(os.path.join(outdir, "image_0", f"{i:06d}.png"),
                    img_l.astype(np.uint8))
        cv2.imwrite(os.path.join(outdir, "image_1", f"{i:06d}.png"),
                    img_r.astype(np.uint8))
        T_w_c = np.eye(4)
        T_w_c[:3, :3] = R.T
        T_w_c[:3, 3] = -R.T @ t
        gt.append(T_w_c[:3].reshape(-1))
    np.savetxt(os.path.join(outdir, "poses.txt"), np.asarray(gt))
    return outdir


@dataclasses.dataclass
class Degradation:
    """Photometric / occlusion stress parameters for synthetic sequences.

    The reference is only ever validated on real recordings whose nuisances
    (sensor noise, auto-exposure steps, foreground occluders) come for free;
    with real datasets environment-blocked, this reproduces those nuisances
    on the closed-form scenes so robustness is a tested property rather
    than an assumption.
    """

    noise_sigma: float = 0.0         # additive Gaussian noise, 0-255 scale
    exposure_step_frame: int = -1    # frame index where auto-exposure jumps
    exposure_gain: float = 1.0       # multiplicative gain after the step
    exposure_bias: float = 0.0       # additive offset after the step
    occlusion_boxes: int = 0         # moving foreground occluder count
    occlusion_size: float = 0.18     # box side as a fraction of image height
    seed: int = 0


def degrade_frame(img_l: np.ndarray, img_r: np.ndarray, frame_idx: int,
                  deg: Degradation):
    """Apply the degradation model to one stereo pair (new arrays).

    Noise is INDEPENDENT per image (two sensors); exposure changes hit both
    (one auto-exposure controller); occluder boxes are drawn in the LEFT
    image only where they also break the stereo match, plus shifted copies
    in the right — they move across frames, unlike the scene, so LK tracks
    landing on them measure wrong flow and must be rejected downstream.
    """
    h, w = img_l.shape
    rng = np.random.default_rng(deg.seed * 100003 + frame_idx)
    il, ir = img_l.copy(), img_r.copy()
    if deg.occlusion_boxes:
        s = int(deg.occlusion_size * h)
        for b in range(deg.occlusion_boxes):
            brng = np.random.default_rng(deg.seed * 7919 + b)
            x0 = int(brng.uniform(0, w - s))
            y0 = int(brng.uniform(0, h - s))
            vx, vy = brng.uniform(-6, 6, 2)          # px/frame, scene-inconsistent
            x = int(np.clip(x0 + vx * frame_idx, 0, w - s))
            y = int(np.clip(y0 + vy * frame_idx, 0, h - s))
            patch = textured_image(brng, s, s) * 0.35
            il[y:y + s, x:x + s] = patch
            xr = max(0, x - 4)                       # occluder disparity ≠ scene
            ir[y:y + s, xr:xr + s] = patch[:, : ir[y:y + s, xr:xr + s].shape[1]]
    if frame_idx >= deg.exposure_step_frame >= 0:
        il = il * deg.exposure_gain + deg.exposure_bias
        ir = ir * deg.exposure_gain + deg.exposure_bias
    if deg.noise_sigma > 0:
        il = il + rng.normal(0, deg.noise_sigma, il.shape)
        ir = ir + rng.normal(0, deg.noise_sigma, ir.shape)
    return (np.clip(il, 0, 255).astype(np.float32),
            np.clip(ir, 0, 255).astype(np.float32))


def periodic_trajectory(num_frames: int, amp: float = None,
                        amp_y: float = 0.08, amp_z: float = 0.04,
                        yaw_amp: float = 0.02):
    """A CLOSED sinusoidal camera path with period exactly `num_frames`:
    position, velocity, and acceleration are all continuous across the
    replay wrap, so benches that stream the same chunk repeatedly see a
    smooth infinite trajectory instead of a teleport at every wrap.

    The open `orbit_trajectory` wraps with a >1 m position jump per replay,
    which drives the tracker through escaped-frame recovery and a keyframe
    storm (~41-51 keyframes per 64-frame chunk measured, vs ~22 on the
    contiguous portion) — a harness artifact no real sequence has, and one
    that doubles the benched BA + loop-ingest cost.  The default `amp`
    scales with the period so mean speed matches orbit_trajectory's
    0.02 m/frame default (mean |dx/di| = amp·(2π/N)·(2/π) = 4·amp/N).
    """
    if amp is None:
        amp = 0.005 * num_frames
    poses = []
    w = 2 * np.pi / num_frames
    for i in range(num_frames):
        yaw = yaw_amp * np.sin(w * i)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_w_c = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        C = np.array([amp * np.sin(w * i),
                      amp_y * np.sin(2 * w * i + 0.7),
                      amp_z * np.sin(w * i + 1.3)])
        R = R_w_c.T
        t = -R @ C
        poses.append((R, t))
    return poses


def orbit_trajectory(num_frames: int, radius: float = 0.5, step: float = 0.02,
                     yaw_rate: float = 0.002):
    """A gently translating + yawing camera path (list of (R, t) world→cam).

    Starts at identity, mostly forward/sideways translation with small yaw —
    representative of the EuRoC/KITTI motion regime.
    """
    poses = []
    for i in range(num_frames):
        yaw = yaw_rate * i
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_w_c = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        C = np.array([step * i, 0.3 * radius * np.sin(0.05 * i), 0.1 * radius * np.sin(0.03 * i)])
        R = R_w_c.T
        t = -R @ C
        poses.append((R, t))
    return poses
