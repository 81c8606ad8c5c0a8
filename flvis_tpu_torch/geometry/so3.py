"""Batched SO(3) on unit quaternions (port of flvis_tpu/geometry/so3.py).

Conventions as in the reference package: Hamilton quaternions ordered
(w, x, y, z) in the last dim, active rotations R(q) v = q ⊗ v ⊗ q⁻¹, and the
rotation-vector chart for exp/log.  Every function broadcasts over leading
batch dims; small-angle branches are selected with torch.where.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def identity(batch_shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0].fill_(1.0)
    return q


def normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def mul(a, b):
    """Hamilton product a ⊗ b, batched."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


inverse = conj  # unit quaternions


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4):
    v' = v + 2 w (u × v) + 2 u × (u × v),  u = q.xyz."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def to_matrix(q):
    """(..., 4) → (..., 3, 3) rotation matrices."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(R):
    """(..., 3, 3) → (..., 4): Shepperd's method, the largest-pivot
    candidate picked per element, sign canonicalised to w ≥ 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)            # (..., 4 cand, 4)
    idx = best[..., None, None].expand(cand.shape[:-2] + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    q = normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def exp(phi):
    """Rotation vector (..., 3) → quaternion (..., 4)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < _EPS
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def log(q):
    """Quaternion (..., 4) → rotation vector (..., 3)."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    n = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    small = n < _EPS
    n_safe = torch.where(small, 1.0, n)
    theta = 2.0 * torch.atan2(n, w)
    k = torch.where(small, 2.0 / torch.clamp(w, min=0.5), theta / n_safe)
    return k * q[..., 1:]


def hat(phi):
    """(..., 3) → (..., 3, 3) skew matrices."""
    z = torch.zeros_like(phi[..., 0])
    x, y, w = phi.unbind(-1)
    m = torch.stack([z, -w, y, w, z, -x, -y, x, z], dim=-1)
    return m.reshape(phi.shape[:-1] + (3, 3))


def slerp(q0, q1, t):
    """Spherical interpolation; lerp for nearly parallel quaternions."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_t = torch.sin(theta)
    near = sin_t < 1e-5
    sin_safe = torch.where(near, 1.0, sin_t)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_safe)
    w1 = torch.where(near, t, torch.sin(t * theta) / sin_safe)
    return normalize(w0 * q0 + w1 * q1)


def from_euler_zyx(rpy):
    """roll/pitch/yaw (..., 3) → quaternion, ZYX convention."""
    r, p, y = (rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def to_euler_zyx(q):
    """Quaternion → roll/pitch/yaw (ZYX), inverse of from_euler_zyx."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.arcsin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)
