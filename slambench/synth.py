"""The benchmark's traffic generator: a textured planar scene seen by a
moving stereo rig, out-and-back laps and the IMU that follows them.

Copied from flvis_tpu_torch/io/synthetic.py at commit 1a1c6dc
(textured_image, PlanarScene.render, imu_from_trajectory) and from the
out-and-back laps of bench.py:368-372 at the same commit, and rewritten in
plain PyTorch so that a lap renders on the card from the seed in a few
large calls.  The benchmark keeps its own copy so that the program cannot
move the yardstick; nothing here imports the program.

The scene is the plane z = plane_depth carrying a multi-octave random
texture drawn from the seed; the camera never rotates (R = I), as in the
reference bench's loop-event sequence, and translates along x.  A lap is
`frames` frames out to `far_m` and back; laps repeat, and every seed gets
the same laps, the same timestamps and the same IMU: the seed changes the
texture alone.
"""

from __future__ import annotations

import numpy as np
import torch


def textured_image(gen: torch.Generator, h: int, w: int, device, octaves: int = 4):
    """Smooth multi-octave random texture in [0, 255], float32 (h, w), on
    `device`: each octave a standard-normal grid upsampled bilinearly."""
    img = torch.zeros((h, w), dtype=torch.float32, device=device)
    for o in range(octaves):
        s = 2 ** (octaves - o)
        small = torch.randn((h // s + 2, w // s + 2), generator=gen, device=device)
        ys = torch.linspace(0, small.shape[0] - 1.001, h, device=device)
        xs = torch.linspace(0, small.shape[1] - 1.001, w, device=device)
        y0, x0 = ys.long(), xs.long()
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        up = (small[y0][:, x0] * (1 - fy) * (1 - fx) + small[y0][:, x0 + 1] * (1 - fy) * fx
              + small[y0 + 1][:, x0] * fy * (1 - fx) + small[y0 + 1][:, x0 + 1] * fy * fx)
        img += up * (2.0 ** o)
    img -= img.min()
    img *= 255.0 / max(float(img.max()), 1e-6)
    return img


class PlanarScene:
    """A textured fronto-parallel plane z = depth, rendered for camera
    centres C (the camera frame is the world frame rotated by nothing)."""

    def __init__(self, cam: dict, seed: int, device, plane_depth: float = 8.0,
                 texture_scale: float = 4.0):
        self.cam = cam
        self.depth = plane_depth
        self.device = device
        gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
        self.tex_h = int(cam["height"] * texture_scale)
        self.tex_w = int(cam["width"] * texture_scale)
        self.tex = textured_image(gen, self.tex_h, self.tex_w, device)
        self.m_per_tpx = plane_depth / cam["fx"] / 2.0

    def render(self, centres, offset_x: float = 0.0):
        """uint8 images (N, H, W) of the camera at each centre (N, 3),
        moved by offset_x along the camera's x axis (the right camera sits
        at +baseline)."""
        c = self.cam
        dev = self.device
        C = torch.as_tensor(np.asarray(centres, np.float64), dtype=torch.float32, device=dev)
        C = C + torch.tensor([offset_x, 0.0, 0.0], device=dev)
        us = torch.arange(c["width"], dtype=torch.float32, device=dev)
        vs = torch.arange(c["height"], dtype=torch.float32, device=dev)
        dx = ((us - c["cx"]) / c["fx"])[None, None, :]
        dy = ((vs - c["cy"]) / c["fy"])[None, :, None]
        lam = (self.depth - C[:, 2])[:, None, None]          # ray z component is 1
        X = C[:, 0, None, None] + lam * dx
        Y = C[:, 1, None, None] + lam * dy
        u = torch.clamp(X / self.m_per_tpx + self.tex_w / 2.0, 0, self.tex_w - 1.001)
        v = torch.clamp(Y / self.m_per_tpx + self.tex_h / 2.0, 0, self.tex_h - 1.001)
        u = u.expand(-1, c["height"], -1)
        v = v.expand(-1, -1, c["width"])
        u0, v0 = u.long(), v.long()
        fu, fv = u - u0, v - v0
        t = self.tex
        img = (t[v0, u0] * (1 - fv) * (1 - fu) + t[v0, u0 + 1] * (1 - fv) * fu
               + t[v0 + 1, u0] * fv * (1 - fu) + t[v0 + 1, u0 + 1] * fv * fu)
        return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)

    def render_stereo(self, centres, baseline: float, batch: int = 32):
        """(left, right) uint8 (N, H, W) tensors on the device, rendered
        `batch` frames a call."""
        left, right = [], []
        for a in range(0, len(centres), batch):
            part = centres[a:a + batch]
            left.append(self.render(part))
            right.append(self.render(part, baseline))
        return torch.cat(left), torch.cat(right)


def lap_positions(frames: int, far_m: float) -> np.ndarray:
    """x of one out-and-back lap (0 → far_m → 0.01), float64 (frames,):
    the shape of bench.py:368-372."""
    half = frames // 2
    return np.concatenate([np.linspace(0.0, far_m, half),
                           np.linspace(far_m, 0.01, frames - half)])


def lap_centres(xs: np.ndarray, seqs: int, offset_m: float) -> np.ndarray:
    """Camera centres (seqs, len(xs), 3) float64 of each sequence's lap:
    sequence s flies the lap xs offset_m·(s - (seqs-1)/2) metres along x."""
    return np.stack([np.stack([xs + offset_m * (s - (seqs - 1) / 2), 0 * xs, 0 * xs], -1)
                     for s in range(seqs)])


def lap_imu(xs: np.ndarray, fps: float, imu_hz: float, gravity: float = 9.81):
    """A lap's IMU as one period of repeating laps: (acc (M, 3), gyro (M, 3))
    float32 at imu_hz, M = len(xs) · imu_hz / fps, sample k at k / imu_hz
    after the lap's first frame.  The camera centre is linear between frames
    and the acceleration its second difference at the IMU rate
    (imu_from_trajectory's model, the laps wrapping); the body never
    rotates, so gyro is 0 and acc = C'' + (0, 0, g)."""
    per = int(round(imu_hz / fps))
    n = len(xs)
    M = n * per
    k = np.arange(-1, M + 1)
    f = k / per
    i0 = np.floor(f).astype(int)
    w = f - i0
    x = xs[i0 % n] * (1 - w) + xs[(i0 + 1) % n] * w
    acc = np.zeros((M, 3), np.float64)
    acc[:, 0] = (x[2:] - 2 * x[1:-1] + x[:-2]) * imu_hz ** 2
    acc[:, 2] += gravity
    return acc.astype(np.float32), np.zeros((M, 3), np.float32)


class Stream:
    """An endless stream of lap frames for S sequences: frame i of the
    stream is lap frame i % frames at time t0 + i / fps.

    Host arrays are what a dataset reader hands over: uint8 images
    (S, frames, H, W), float64 timestamps, float32 IMU samples.  `gt_centres`
    is the ground truth the reference reads: camera centres in the world
    frame of the scene, (S, frames, 3) float64 for one lap.  Sequence s
    starts offset_m·(s - (S-1)/2) metres along x from the scene's centre,
    so that a fleet's flights see different parts of the scene."""

    T0 = 100.0

    def __init__(self, cam: dict, scene: dict, lap: dict, seqs: int, seed: int, device,
                 imu: bool = True, offset_m: float = 0.0):
        self.fps = float(cam["camera_hz"])
        self.imu_hz = float(cam.get("imu_hz", 0.0))
        self.frames = int(lap["frames"])
        self.S = seqs
        xs = lap_positions(self.frames, float(lap["far_m"]))
        self.gt_centres = lap_centres(xs, seqs, offset_m)
        sc = PlanarScene(cam, seed, device, float(scene["plane_depth"]),
                         float(scene["texture_scale"]))
        left, right = [], []
        for s in range(seqs):
            l, r = sc.render_stereo(self.gt_centres[s], float(cam["baseline"]))
            left.append(l)
            right.append(r)
        self.left = torch.stack(left).cpu().numpy()
        self.right = torch.stack(right).cpu().numpy()
        del sc
        self.gravity = 9.81
        self.imu = lap_imu(xs, self.fps, self.imu_hz, self.gravity) if imu else None
        self.per = int(round(self.imu_hz / self.fps)) if imu else 0

    def times(self, i0: int, T: int) -> np.ndarray:
        return self.T0 + np.arange(i0, i0 + T, dtype=np.float64) / self.fps

    def images(self, i0: int, T: int):
        """(left, right) host uint8 (S, T, H, W) of stream frames i0..i0+T-1
        (T divides the lap and i0 is a multiple of T)."""
        a = i0 % self.frames
        return self.left[:, a:a + T], self.right[:, a:a + T]

    def imu_lists(self, i0: int, T: int):
        """Per frame the samples since the previous frame, as lists of
        (acc (n, 3), gyro (n, 3), t (n,)): frame 0 gets the sample at its
        own time, every later frame the per samples after the previous
        frame up to its own time."""
        acc, gyro, ts = [], [], []
        M = len(self.imu[0])
        for i in range(i0, i0 + T):
            if i == 0:
                # The stream's first sample: gravity alone, as imu_from_trajectory
                # leaves its first sample (no lap came before it).
                ks = np.arange(0, 1)
                acc.append(np.asarray([[0.0, 0.0, self.gravity]], np.float32))
            else:
                ks = np.arange((i - 1) * self.per + 1, i * self.per + 1)
                acc.append(self.imu[0][ks % M])
            gyro.append(self.imu[1][ks % M])
            ts.append(self.T0 + ks / self.imu_hz)
        return acc, gyro, ts

    def imu_packed(self, i0: int, T: int, pad: int = 16):
        """The same samples packed (T, pad, ·) with a validity mask."""
        acc, gyro, ts = self.imu_lists(i0, T)
        A = np.zeros((T, pad, 3), np.float32)
        G = np.zeros((T, pad, 3), np.float32)
        Tt = np.zeros((T, pad), np.float32)
        V = np.zeros((T, pad), bool)
        for i in range(T):
            n = len(ts[i])
            A[i, :n], G[i, :n], Tt[i, :n], V[i, :n] = acc[i], gyro[i], ts[i], True
        return A, G, Tt, V
