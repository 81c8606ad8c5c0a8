"""RANSAC as masked batched hypothesis scoring (port of flvis_tpu/ops/ransac.py).

Random draws: the reference samples `jax.random.uniform(key, (M, N))`
scores per (hypothesis, point) inside `sample_minimal_sets` (ransac.py:30).
A torch generator cannot reproduce those bits, so here the caller passes
the (M, N) uniform scores in: the tracker draws them from its
torch.Generator, and the parity tests hand in JAX's own draws.
"""

from __future__ import annotations

import torch

from .features import stable_topk


def sample_minimal_sets(scores, valid, sample_size: int):
    """(M, k) indices of random valid points per hypothesis: the top-k of
    uniform scores (M, N) with invalid slots at -inf (lowest index first
    among ties, as lax.top_k)."""
    scores = torch.where(valid[None, :], scores, -torch.inf)
    return stable_topk(scores, sample_size)[1]


def _hartley_normalize(pts, valid):
    """Similarity transform sending valid points to zero mean, RMS √2."""
    w = valid.to(pts.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    d = torch.linalg.vector_norm(pts - mean, dim=-1)
    scale = 2.0 ** 0.5 / torch.clamp(torch.sum(d * w) / n, min=1e-8)
    one = torch.ones_like(scale)
    zero = torch.zeros_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -mean[0] * scale]),
        torch.stack([zero, scale, -mean[1] * scale]),
        torch.stack([zero, zero, one]),
    ])
    return (pts - mean) * scale, T


def _rank2_project(F):
    """Nearest rank-2 matrix via 12 shifted power steps on FᵀF."""
    G = torch.einsum("mji,mjk->mik", F, F)
    sigma = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    B = sigma * torch.eye(3, dtype=F.dtype, device=F.device) - G
    v = torch.full((F.shape[0], 3), 1.0 / 3.0 ** 0.5, dtype=F.dtype, device=F.device)
    v = v + torch.tensor([0.0, 1e-3, -2e-3], dtype=F.dtype, device=F.device)
    for _ in range(12):
        v = torch.einsum("mij,mj->mi", B, v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)
    return F - torch.einsum("mij,mj,mk->mik", F, v, v)


def _eight_point(p0, p1):
    """Batched 8-point fundamental matrix. p0, p1: (M, 8, 2) → (M, 3, 3)."""
    from . import linalg as la

    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     torch.ones_like(x0)], dim=-1)
    return _rank2_project(la.gs_null(A).reshape(-1, 3, 3))


def sampson_distance(F, p0, p1):
    """Squared Sampson distance. F: (M,3,3), p0/p1: (N,2) → (M,N)."""
    x0 = torch.cat([p0, torch.ones_like(p0[:, :1])], dim=-1)
    x1 = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=-1)
    Fx0 = torch.einsum("mij,nj->mni", F, x0)
    Ftx1 = torch.einsum("mji,nj->mni", F, x1)
    num = torch.einsum("ni,mni->mn", x1, Fx0) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def fundamental_ransac(scores, pts0, pts1, valid, threshold=3.0):
    """Fundamental-matrix RANSAC gate with one hypothesis per row of the
    (M, N) uniform `scores`.  Returns (inliers (N,), best_F (3, 3) in
    pixels, num_inliers)."""
    n0, T0 = _hartley_normalize(pts0, valid)
    n1, T1 = _hartley_normalize(pts1, valid)
    idx = sample_minimal_sets(scores, valid, 8)
    F = _eight_point(n0[idx], n1[idx])
    d2 = sampson_distance(F, n0, n1)
    s = 0.5 * (T0[0, 0] + T1[0, 0])
    inl = (d2 < (threshold * s) ** 2) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    return inl[best], T1.T @ F[best] @ T0, counts[best]


def mad_gate(residuals, valid, sigma_mult=3.0, min_threshold=1.5):
    """Median-absolute-deviation gate: residual < max(min_threshold,
    median + sigma_mult·1.4826·MAD), over the valid entries (the lower
    median, as the reference indexes (n-1)//2 of the sorted list)."""
    n = torch.clamp(torch.sum(valid), min=1)
    k = ((n - 1) // 2).reshape(1)
    srt = torch.sort(torch.where(valid, residuals, torch.inf)).values
    med = torch.gather(srt, 0, k)[0]
    dev = torch.sort(torch.where(valid, torch.abs(residuals - med), torch.inf)).values
    mad = torch.gather(dev, 0, k)[0]
    thr = torch.clamp(med + sigma_mult * 1.4826 * mad, min=min_threshold)
    return valid & (residuals < thr), thr
