"""Batched perspective-n-point: linear EPnP minimal solver + masked RANSAC
(port of flvis_tpu/ops/pnp.py).  The tracker runs it as its prior-free
rescue when the motion BA starves (tracker.py:402-424).

Random draws: as in ops/ransac.py, the (M, N) uniform scores that pick the
minimal samples are passed in by the caller (pnp.py:150 draws them with
jax.random in the reference).
"""

from __future__ import annotations

import torch

from ..geometry import so3
from ..geometry.se3 import SE3
from . import linalg as la
from . import ransac as ransac_ops


def procrustes_quat(src, dst, weights=None):
    """Rigid (q, t) minimising Σ w‖R(q)·src + t − dst‖² (Horn's quaternion
    method, dominant eigenvector by fixed-count power iteration)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights[..., None]
    wsum = torch.sum(w, dim=-2, keepdim=True)
    mu_s = torch.sum(src * w, dim=-2, keepdim=True) / torch.clamp(wsum, min=1e-9)
    mu_d = torch.sum(dst * w, dim=-2, keepdim=True) / torch.clamp(wsum, min=1e-9)
    M = torch.einsum("...na,...nb->...ab", (src - mu_s) * w, dst - mu_d)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    q = la.max_eigvec_sym(N)
    return q, mu_d[..., 0, :] - so3.rotate(q, mu_s[..., 0, :])


def _epnp_minimal(X, xn):
    """Linear EPnP for minimal samples X (M, K, 3), xn (M, K, 2) → SE3 (M,)."""
    M, K, _ = X.shape
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    c0 = torch.mean(X, dim=1, keepdim=True)
    Xc = X - c0
    cov = torch.einsum("mki,mkj->mij", Xc, Xc) / K
    axes = la.chol3(cov, jitter=1e-9)
    Cw = torch.cat([c0, c0 + axes.transpose(1, 2)], dim=1)          # (M, 4, 3)

    B = (Cw[:, 1:] - Cw[:, :1]).transpose(1, 2)
    B_inv = la.inv3(B + 1e-9 * eye3)
    a123 = torch.einsum("mij,mkj->mki", B_inv, Xc)
    alpha = torch.cat([1.0 - torch.sum(a123, dim=-1, keepdim=True), a123], dim=-1)

    u = xn[..., 0]
    v = xn[..., 1]
    zeros = torch.zeros_like(alpha)
    row_u = torch.stack([alpha, zeros, -u[..., None] * alpha], dim=-1)
    row_v = torch.stack([zeros, alpha, -v[..., None] * alpha], dim=-1)
    A = torch.cat([row_u.reshape(M, K, 12), row_v.reshape(M, K, 12)], dim=1)
    Cc = la.gs_null(A[:, : min(2 * K, 11)]).reshape(M, 4, 3)

    def pdists(C):
        pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        return torch.stack([C[:, i] - C[:, j] for i, j in pairs], dim=1)

    dw = torch.linalg.vector_norm(pdists(Cw), dim=-1)
    dv = torch.linalg.vector_norm(pdists(Cc), dim=-1)
    beta = torch.sum(dw * dv, dim=-1) / torch.clamp(torch.sum(dv * dv, dim=-1), min=1e-12)
    Cc = Cc * beta[:, None, None]
    zmean = torch.einsum("mki,mk->mi", Cc, torch.mean(alpha, dim=1))[:, 2]
    Cc = Cc * torch.where(zmean < 0, -1.0, 1.0)[:, None, None]
    q, t = procrustes_quat(Cw, Cc)
    return SE3(q, t)


def pnp_ransac(scores, pts_w, xn, valid, threshold_n: float = 0.01,
               sample_size: int = 6):
    """Prior-free pose from 3D-2D matches, one hypothesis per row of the
    (M, N) uniform `scores`.  Returns (T_c_w, inliers (N,), num_inliers)."""
    idx = ransac_ops.sample_minimal_sets(scores, valid, sample_size)
    T = _epnp_minimal(pts_w[idx], xn[idx])
    p_c = so3.rotate(T.q[:, None, :], pts_w[None, :, :]) + T.t[:, None, :]
    z = p_c[..., 2]
    zs = torch.where(torch.abs(z[..., None]) < 1e-6, 1e-6, z[..., None])
    err = torch.linalg.vector_norm(p_c[..., :2] / zs - xn[None, :, :], dim=-1)
    inl = (err < threshold_n) & (z > 0.05) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    return SE3(T.q[best], T.t[best]), inl[best], counts[best]
