"""Batched SE(3) rigid transforms as (quaternion, translation) pairs
(port of flvis_tpu/geometry/se3.py).

`SE3(q, t)`: q (..., 4) Hamilton wxyz unit quaternion, t (..., 3); the
action is x_out = R(q) x + t.  Everything broadcasts over leading dims.
"""

from __future__ import annotations

import dataclasses

import torch

from . import so3

_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class SE3:
    q: torch.Tensor  # (..., 4) unit quaternion wxyz
    t: torch.Tensor  # (..., 3)

    @property
    def batch_shape(self):
        return self.t.shape[:-1]

    def __matmul__(self, other: "SE3") -> "SE3":
        return compose(self, other)


def identity(batch_shape=(), dtype=torch.float32, device=None) -> SE3:
    return SE3(so3.identity(batch_shape, dtype, device),
               torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device))


def compose(a: SE3, b: SE3) -> SE3:
    """a ∘ b: apply b first, then a."""
    return SE3(so3.normalize(so3.mul(a.q, b.q)), so3.rotate(a.q, b.t) + a.t)


def inverse(T: SE3) -> SE3:
    qi = so3.conj(T.q)
    return SE3(qi, -so3.rotate(qi, T.t))


def transform_points(T: SE3, pts):
    """Transform points (N, 3) by one SE3 (or batched 1:1)."""
    return so3.rotate(T.q, pts) + T.t


def exp(xi) -> SE3:
    """se(3) twist (..., 6) [rho, phi] → SE3."""
    rho, phi = xi[..., :3], xi[..., 3:]
    q = so3.exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    cr = so3._cross(phi, rho)
    t = rho + a * cr + b * so3._cross(phi, cr)
    return SE3(q, t)


def log(T: SE3):
    """SE3 → twist (..., 6) [rho, phi]."""
    phi = so3.log(T.q)
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    half = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / torch.clamp(theta2, min=_EPS * _EPS),
    )
    cr = so3._cross(phi, T.t)
    rho = T.t - 0.5 * cr + cot_term * so3._cross(phi, cr)
    return torch.cat([rho, phi], dim=-1)


def retract_left(T: SE3, xi) -> SE3:
    """Left retraction exp(xi) ∘ T, the LM solvers' update."""
    return compose(exp(xi), T)


def distance(a: SE3, b: SE3):
    """(translation L2, rotation angle) between two poses — the keyframe
    decision metric."""
    rel = compose(inverse(a), b)
    return (torch.linalg.vector_norm(rel.t, dim=-1),
            torch.linalg.vector_norm(so3.log(rel.q), dim=-1))


def where(cond, a: SE3, b: SE3) -> SE3:
    """Elementwise select of two poses on a (batch-shaped) mask."""
    c = cond[..., None]
    return SE3(torch.where(c, a.q, b.q), torch.where(c, a.t, b.t))
