"""Batched two-view triangulation (port of flvis_tpu/geometry/triangulation.py).

Inputs are normalized image coordinates, so a projection "matrix" is an SE3
pose.  `triangulate_midpoint` is what the tracker runs; the DLT form uses
torch.linalg.eigh on the 4×4 normal matrices, as the reference uses
jnp.linalg.eigh.
"""

from __future__ import annotations

import torch

from . import se3 as se3m, so3
from .se3 import SE3


def _pose_rows(T: SE3):
    R = so3.to_matrix(T.q)
    return torch.cat([R, T.t[..., :, None]], dim=-1)


def triangulate_dlt(T0: SE3, T1: SE3, xn0, xn1):
    """DLT triangulation of N correspondences; returns (pts_w (..., N, 3),
    cond_ok (..., N))."""
    P0 = _pose_rows(T0)
    P1 = _pose_rows(T1)

    def rows(P, xn):
        p0, p1, p2 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
        x = xn[..., 0:1]
        y = xn[..., 1:2]
        return (x * p2[..., None, :] - p0[..., None, :],
                y * p2[..., None, :] - p1[..., None, :])

    a0, a1 = rows(P0, xn0)
    a2, a3 = rows(P1, xn1)
    A = torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), dim=-2)  # (..., N, 4, 4)
    AtA = torch.einsum("...ij,...ik->...jk", A, A)
    w, V = torch.linalg.eigh(AtA)
    h = V[..., :, 0]
    w_h = h[..., 3]
    w_safe = torch.where(torch.abs(w_h) < 1e-10, 1e-10, w_h)
    pts = h[..., :3] / w_safe[..., None]
    cond_ok = (w[..., 1] - w[..., 0]) > 1e-9 * torch.clamp(w[..., 3], min=1e-12)
    return pts, cond_ok


def triangulate_from_views(T_c0_w: SE3, T_c1_w: SE3, xn0, xn1, range_max=10.0,
                           range_min=0.1):
    """Two-pose DLT triangulation with cheirality + range gates; points are
    returned in the first camera's frame."""
    pts_w, cond_ok = triangulate_dlt(T_c0_w, T_c1_w, xn0, xn1)
    pts_c0 = se3m.transform_points(T_c0_w, pts_w)
    pts_c1 = se3m.transform_points(T_c1_w, pts_w)
    z0 = pts_c0[..., 2]
    z1 = pts_c1[..., 2]
    valid = cond_ok & (z0 > range_min) & (z0 < range_max) & (z1 > 0.0)
    return pts_c0, valid


def triangulate_midpoint(T_c0_w: SE3, T_c1_w: SE3, xn0, xn1,
                         range_max=10.0, range_min=0.1):
    """Closed-form two-ray midpoint triangulation; poses and rays pair 1:1
    (xn* (..., 2), T_* broadcasting elementwise).  Returns (pts in the first
    camera's frame, cheirality+range validity)."""
    ones = torch.ones(xn0.shape[:-1] + (1,), dtype=xn0.dtype, device=xn0.device)
    h0 = torch.cat([xn0, ones], dim=-1)
    h1 = torch.cat([xn1, ones], dim=-1)
    q0c = so3.conj(T_c0_w.q)
    q1c = so3.conj(T_c1_w.q)
    C0 = -so3.rotate(q0c, T_c0_w.t)
    C1 = -so3.rotate(q1c, T_c1_w.t)
    u0 = so3.rotate(q0c, h0)
    u1 = so3.rotate(q1c, h1)
    w = C1 - C0

    a00 = torch.sum(u0 * u0, -1)
    a01 = torch.sum(u0 * u1, -1)
    a11 = torch.sum(u1 * u1, -1)
    b0 = torch.sum(u0 * w, -1)
    b1 = torch.sum(u1 * w, -1)
    det = a00 * a11 - a01 * a01
    det_safe = torch.where(det < 1e-12, 1.0, det)
    a = (a11 * b0 - a01 * b1) / det_safe
    b = (a01 * b0 - a00 * b1) / det_safe
    P = 0.5 * (C0 + a[..., None] * u0 + C1 + b[..., None] * u1)
    pts_c0 = so3.rotate(T_c0_w.q, P) + T_c0_w.t
    z0 = pts_c0[..., 2]
    cond_ok = det > 1e-6 * a00 * a11
    valid = cond_ok & (a > 0.0) & (b > 0.0) & (z0 > range_min) & (z0 < range_max)
    return pts_c0, valid


def stereo_rectified_depth(fx, baseline, u_left, u_right):
    """z = fx·b / (uL − uR) for rectified stereo."""
    disp = u_left - u_right
    valid = disp > 0.25
    return fx * baseline / torch.clamp(disp, min=0.25), valid


def reprojection_error(cam_project, T_c_w: SE3, pts_w, uv_obs):
    uv = cam_project(se3m.transform_points(T_c_w, pts_w))
    return torch.linalg.vector_norm(uv - uv_obs, dim=-1)
