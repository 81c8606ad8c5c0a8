"""Closed-form / fixed-iteration small linear algebra used by the RANSAC and
PnP solvers (port of the parts of flvis_tpu/ops/linalg.py they call).
Batched over leading dims, no data-dependent control flow."""

from __future__ import annotations

import torch


def inv3(B):
    """Closed-form inverse of general (..., 3, 3) matrices."""
    a, b, c = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2]
    d, e, f = B[..., 1, 0], B[..., 1, 1], B[..., 1, 2]
    g, h, i = B[..., 2, 0], B[..., 2, 1], B[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    idet = torch.where(torch.abs(det) > 1e-20, 1.0 / det, 0.0)[..., None, None]
    adj = torch.stack([
        torch.stack([A00, A01, A02], -1),
        torch.stack([A10, A11, A12], -1),
        torch.stack([A20, A21, A22], -1),
    ], -2)
    return adj * idet


def chol3(S, jitter: float = 1e-9):
    """Closed-form lower Cholesky factor of symmetric PSD (..., 3, 3)."""
    l00 = torch.sqrt(torch.clamp(S[..., 0, 0], min=jitter))
    l10 = S[..., 1, 0] / l00
    l20 = S[..., 2, 0] / l00
    l11 = torch.sqrt(torch.clamp(S[..., 1, 1] - l10 * l10, min=jitter))
    l21 = (S[..., 2, 1] - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(S[..., 2, 2] - l20 * l20 - l21 * l21, min=jitter))
    z = torch.zeros_like(l00)
    return torch.stack([
        torch.stack([l00, z, z], -1),
        torch.stack([l10, l11, z], -1),
        torch.stack([l20, l21, l22], -1),
    ], -2)


def gs_null(A):
    """Unit vector most orthogonal to the rows of A (..., R, C), R < C:
    CGS2 orthonormalisation of the rows, then the best-conditioned column
    of I − QᵀQ.  Numerically dependent rows are dropped."""
    R, C = A.shape[-2], A.shape[-1]
    qs = []
    for j in range(R):
        v = A[..., j, :]
        for _ in range(2):
            for qi in qs:
                v = v - torch.sum(qi * v, -1, keepdim=True) * qi
        n2 = torch.sum(v * v, -1, keepdim=True)
        v = torch.where(n2 > 1e-16, v / torch.sqrt(torch.clamp(n2, min=1e-20)), 0.0)
        qs.append(v)
    Q = torch.stack(qs, dim=-2)
    P = torch.eye(C, dtype=A.dtype, device=A.device) - torch.einsum("...kj,...kl->...jl", Q, Q)
    diag = torch.diagonal(P, dim1=-2, dim2=-1)
    pick = torch.argmax(diag, dim=-1)
    h = torch.take_along_dim(P, pick[..., None, None], dim=-1)[..., 0]
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-12)


def max_eigvec_sym(K, squarings: int = 5, iters: int = 3):
    """Dominant eigenvector of symmetric (..., D, D) by repeated squaring of
    the shifted matrix, then a few power steps — fixed op count."""
    D = K.shape[-1]
    shift = torch.sqrt(torch.sum(K * K, dim=(-2, -1), keepdim=True)) + 1e-6
    M = (K + shift * torch.eye(D, dtype=K.dtype, device=K.device)) / shift
    for _ in range(squarings):
        M = M @ M
        M = M / torch.clamp(torch.sqrt(torch.sum(M * M, dim=(-2, -1), keepdim=True)),
                            min=1e-30)
    v = torch.full(K.shape[:-1], 1.0 / D ** 0.5, dtype=K.dtype, device=K.device)
    v = v + 1e-3 * torch.arange(D, dtype=K.dtype, device=K.device)
    for _ in range(iters):
        v = torch.einsum("...ij,...j->...i", M, v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)
    return v
