"""Motion-only bundle adjustment: robust single-pose Levenberg-Marquardt
(port of flvis_tpu/backend/motion_ba.py).

Analytic 2×6 Jacobians for all landmarks at once, Huber IRLS weights, and
the damped step solved on the Jacobian by CGS2-QR (not the normal
equations: cond(H) = cond(J)² breaks float32 on near-uniform-depth scenes).
The reference's fori_loop has a static trip count; here it is a Python
loop of the same length, and every accept/reject is a torch.where.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3 as se3m, so3
from ..geometry.camera import StereoCamera, project
from ..geometry.se3 import SE3


class MotionBAResult(NamedTuple):
    T_c_w: SE3
    chi2: torch.Tensor        # (N,) final squared pixel residuals
    inliers: torch.Tensor     # (N,) bool
    cost: torch.Tensor
    num_inliers: torch.Tensor


def _residuals_jacobians(cam: StereoCamera, T: SE3, pts_w, uv_obs):
    """Residuals (N, 2), Jacobians (N, 2, 6) wrt left retraction, behind mask."""
    p_c = se3m.transform_points(T, pts_w)
    r = project(cam, p_c) - uv_obs
    x, y = p_c[:, 0], p_c[:, 1]
    z = torch.where(torch.abs(p_c[:, 2]) < 1e-6, 1e-6, p_c[:, 2])
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    duv = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
    ], dim=1)
    eye = torch.eye(3, dtype=p_c.dtype, device=p_c.device).expand(p_c.shape[:-1] + (3, 3))
    dp = torch.cat([eye, -so3.hat(p_c)], dim=-1)
    return r, duv @ dp, p_c[:, 2] <= 0.05


def _huber_weight(r2, delta):
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    return torch.where(r <= delta, 1.0, delta / r)


def _qr_solve6(A, b):
    """Least-squares solve of a tall (M, 6) system by unrolled CGS2 QR."""
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    q_cols, r_cols = [], []
    for j in range(6):
        v = A[:, j]
        coef = [zero] * j
        for _ in range(2):  # CGS2: the second pass removes f32 projection residue
            for i, qi in enumerate(q_cols):
                c = torch.dot(qi, v)
                coef[i] = coef[i] + c
                v = v - c * qi
        nrm = torch.sqrt(torch.clamp(torch.dot(v, v), min=1e-20))
        r_cols.append(torch.stack(coef + [nrm] + [zero] * (5 - j)))
        q_cols.append(v / nrm)
    Q = torch.stack(q_cols, dim=1)
    R = torch.stack(r_cols, dim=1)                     # upper-triangular
    y = Q.T @ b
    x = torch.zeros(6, dtype=A.dtype, device=A.device)
    for j in range(5, -1, -1):
        x[j] = (y[j] - torch.dot(R[j], x)) / R[j, j]
    return x


def _cost(cam, T, pts_w, uv_obs, active, huber_delta):
    p_c = se3m.transform_points(T, pts_w)
    r = project(cam, p_c) - uv_obs
    r2 = torch.sum(r * r, dim=-1)
    rn = torch.sqrt(torch.clamp(r2, min=1e-12))
    rho = torch.where(rn <= huber_delta, 0.5 * r2, huber_delta * (rn - 0.5 * huber_delta))
    return torch.sum(torch.where(active & (p_c[:, 2] > 0.05), rho, 0.0))


def _lm_iterations(cam, T, pts_w, uv_obs, active, iters: int, huber_delta, lam0):
    lam = torch.full((), lam0, dtype=pts_w.dtype, device=pts_w.device)
    cost = _cost(cam, T, pts_w, uv_obs, active, huber_delta)
    for _ in range(iters):
        r, J, behind = _residuals_jacobians(cam, T, pts_w, uv_obs)
        use = active & ~behind
        w = _huber_weight(torch.sum(r * r, dim=-1), huber_delta) * use.to(r.dtype)
        sw = torch.sqrt(w)[:, None]
        Jw = (J * sw[..., None]).reshape(-1, 6)
        rw = (r * sw).reshape(-1)
        col = torch.sqrt(lam * torch.sum(Jw * Jw, dim=0) + 1e-12)
        A = torch.cat([Jw, torch.diag(col)], dim=0)
        rhs = torch.cat([-rw, torch.zeros(6, dtype=rw.dtype, device=rw.device)])
        T_new = se3m.retract_left(T, _qr_solve6(A, rhs))
        new_cost = _cost(cam, T_new, pts_w, uv_obs, active, huber_delta)
        better = new_cost < cost
        T = se3m.where(better, T_new, T)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e4))
        cost = torch.where(better, new_cost, cost)
    return T, cost


def optimize_pose(cam: StereoCamera, T_init: SE3, pts_w, uv_obs, valid,
                  iters1: int = 3, iters2: int = 5, huber_delta: float = 2.0,
                  chi2_cull: float = 9.0, min_points: int = 10) -> MotionBAResult:
    """Robust motion-only BA: LM pass, adaptive chi² cull, LM pass on the
    survivors; below min_points observations the input pose is returned."""
    n_valid = torch.sum(valid)
    T1, _ = _lm_iterations(cam, T_init, pts_w, uv_obs, valid, iters1, huber_delta, 1e-3)

    r, _, behind = _residuals_jacobians(cam, T1, pts_w, uv_obs)
    chi2 = torch.sum(r * r, dim=-1)
    # jnp.nanmedian averages the two middle values; torch.nanmedian returns
    # the lower one — nanquantile(0.5) interpolates like the reference.
    med = torch.nanquantile(torch.where(valid & ~behind, chi2, torch.nan), 0.5)
    adaptive = torch.clamp(9.0 * torch.nan_to_num(med, nan=chi2_cull), min=0.25,
                           max=chi2_cull)
    keep = valid & ~behind & (chi2 < adaptive)

    T2, cost = _lm_iterations(cam, T1, pts_w, uv_obs, keep, iters2, huber_delta, 1e-4)

    r2, _, behind2 = _residuals_jacobians(cam, T2, pts_w, uv_obs)
    chi2_final = torch.sum(r2 * r2, dim=-1)
    inliers = keep & ~behind2 & (chi2_final < chi2_cull)
    enough = (n_valid >= min_points) & (torch.sum(keep) >= min_points)
    T_out = se3m.where(enough, T2, T_init)
    inliers = torch.where(enough, inliers, keep)
    return MotionBAResult(T_out, chi2_final, inliers, cost, torch.sum(inliers))
