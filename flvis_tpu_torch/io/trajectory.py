"""Copy of flvis_tpu/io/trajectory.py (the port keeps its own; it imports nothing of flvis_tpu).

Trajectory file I/O: TUM and KITTI formats.

Replaces the reference's vo_repub_rec recorder node
(the reference: src/independ_modules/vo_repub_rec.cpp:33-254), which writes
TUM-format (timestamp tx ty tz qx qy qz qw, lines 74-98) and KITTI-format
(3×4 row-major pose matrices, lines 100-124) files used as the evaluation
tap by every launch file.
"""

from __future__ import annotations

import numpy as np


def write_tum(path, timestamps, positions, quats_wxyz):
    """TUM: `t tx ty tz qx qy qz qw` per line (vo_repub_rec.cpp:74-98)."""
    with open(path, "w") as f:
        for t, p, q in zip(timestamps, positions, quats_wxyz):
            f.write(
                f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n"
            )


def read_tum(path):
    """→ (timestamps (N,), positions (N, 3), quats wxyz (N, 4))."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    t = data[:, 0]
    p = data[:, 1:4]
    q_xyzw = data[:, 4:8]
    q = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, :3]], axis=1)
    return t, p, q


def write_kitti(path, poses_w_c):
    """KITTI: 12 numbers per line, row-major 3×4 of T_w_c
    (vo_repub_rec.cpp:100-124)."""
    with open(path, "w") as f:
        for T in poses_w_c:
            T = np.asarray(T)
            f.write(" ".join(f"{v:.6e}" for v in T[:3, :4].reshape(-1)) + "\n")


def read_kitti(path):
    """→ (N, 4, 4) homogeneous T_w_c."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    n = data.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :4] = data.reshape(n, 3, 4)
    return out
