"""Rectified stereo pinhole camera (port of flvis_tpu/geometry/camera.py).

The device-side model is an ideal rectified pinhole pair: the right camera
shares cam0's intrinsics and sits at `baseline` along +x, so
u_right = u_left − fx·b/z.  Intrinsics are 0-d tensors on the caller's
device; width/height are plain ints (shape-determining).
"""

from __future__ import annotations

import dataclasses

import torch

from . import se3 as se3m
from .se3 import SE3


@dataclasses.dataclass(frozen=True)
class StereoCamera:
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    baseline: torch.Tensor      # metres; 0 for pure RGB-D
    depth_factor: torch.Tensor  # raw depth units → metres divisor
    width: int = 640
    height: int = 480


def make(fx, fy, cx, cy, baseline=0.0, depth_factor=1000.0, width=640, height=480,
         *, device, dtype=torch.float32) -> StereoCamera:
    def f(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return StereoCamera(f(fx), f(fy), f(cx), f(cy), f(baseline), f(depth_factor),
                        int(width), int(height))


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-6, 1e-6, z)


def project(cam: StereoCamera, pts_c):
    """Camera-frame points (..., 3) → cam0 pixels (..., 2)."""
    uv = pts_c[..., :2] / _safe_z(pts_c[..., 2:3])
    return torch.stack([cam.fx * uv[..., 0] + cam.cx, cam.fy * uv[..., 1] + cam.cy],
                       dim=-1)


def project_stereo(cam: StereoCamera, pts_c):
    """→ (u_left, v, u_right) (..., 3)."""
    zs = _safe_z(pts_c[..., 2])
    x, y = pts_c[..., 0], pts_c[..., 1]
    ul = cam.fx * x / zs + cam.cx
    v = cam.fy * y / zs + cam.cy
    ur = ul - cam.fx * cam.baseline / zs
    return torch.stack([ul, v, ur], dim=-1)


def backproject(cam: StereoCamera, uv, depth):
    """Pixels (..., 2) + depth (...,) → camera-frame points (..., 3)."""
    d = depth[..., None]
    x = (uv[..., 0:1] - cam.cx) / cam.fx * d
    y = (uv[..., 1:2] - cam.cy) / cam.fy * d
    return torch.cat([x, y, d], dim=-1)


def unit_ray(cam: StereoCamera, uv):
    """Pixels → normalized-plane rays (..., 3) with z=1."""
    x = (uv[..., 0:1] - cam.cx) / cam.fx
    y = (uv[..., 1:2] - cam.cy) / cam.fy
    return torch.cat([x, y, torch.ones_like(x)], dim=-1)


def world_to_cam(T_c_w: SE3, pts_w):
    return se3m.transform_points(T_c_w, pts_w)


def cam_to_world(T_c_w: SE3, pts_c):
    return se3m.transform_points(se3m.inverse(T_c_w), pts_c)


def project_world(cam: StereoCamera, T_c_w: SE3, pts_w):
    return project(cam, world_to_cam(T_c_w, pts_w))


def in_bounds(cam: StereoCamera, uv, margin=0.0):
    return ((uv[..., 0] >= margin) & (uv[..., 0] <= cam.width - 1 - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] <= cam.height - 1 - margin))
