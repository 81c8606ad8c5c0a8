"""attitude_chain: the sequential Madgwick attitude recurrence of one IMU
packet,

    q_k = normalize( (q_{k-1} ⊗ G_k) ⊗ exp(c_k · a_k × ĝ(q_{k-1} ⊗ G_k)) ),

with ĝ(q) = R(q)ᵀ ẑ the predicted gravity direction in the IMU frame.

Replaces the TPU kernel flvis_tpu/ops/pallas/imu_chain.py:attitude_chain_pallas
(called from vio/vimotion._feed_prop_batch on every IMU packet once the
filter is initialised, i.e. on every VIO frame).

On the H100 the kernel (csrc/imu_chain.cu) is latency-bound: a 16-sample
packet is ~0.8 KB in and out and ~1.3k flops, so its bound is one launch,
not bytes or operations.  The chain is sequential in q, so the design is
one thread per chain with the P samples as a register loop: the whole
packet costs one launch instead of the ~160 small launches of the plain
version.  The C entry takes a batch of B chains (one per sequence, as a
multi-sequence caller would need); the wrapper passes B = 1.  Like the TPU
kernel it uses the 2nd-order small-angle series for the correction exp
(cw = 1 − θ²/8, s = ½(1 − θ²/24)); |θ| ≤ 10·β·dt ≈ 0.025 rad there, so the
series error is ~1e-7 after renormalising, and the kernel is held to the
plain version (exact exp) at 1e-6.
"""

from __future__ import annotations

import torch

from ...geometry import so3
from . import _build


def attitude_chain_plain(q0, G, a_unit, c):
    """Plain PyTorch version (the reference's attitude_chain_ref): the same
    recurrence with the exact so3.exp.  q0 (4,), G (P, 4), a_unit (P, 3),
    c (P,) → (P, 4)."""
    z = torch.tensor([0.0, 0.0, 1.0], dtype=q0.dtype, device=q0.device)
    q = q0
    out = []
    for k in range(G.shape[0]):
        qp = so3.mul(q, G[k])
        g_pred = so3.rotate(so3.conj(qp), z)
        err = torch.linalg.cross(a_unit[k], g_pred)
        q = so3.normalize(so3.mul(qp, so3.exp(err * c[k])))
        out.append(q)
    return torch.stack(out)


def attitude_chain_kernel(q0, G, a_unit, c):
    """Launch csrc/imu_chain.cu on contiguous float32 CUDA tensors."""
    _build.require_cuda_f32("attitude_chain", q0=q0, G=G, a_unit=a_unit, c=c)
    P = G.shape[0]
    if (q0.shape != (4,) or G.dim() != 2 or G.shape[1] != 4
            or a_unit.shape != (P, 3) or c.shape != (P,)):
        raise ValueError("attitude_chain: expected q0 (4,), G (P, 4), a_unit (P, 3), "
                         f"c (P,); got {tuple(q0.shape)}, {tuple(G.shape)}, "
                         f"{tuple(a_unit.shape)}, {tuple(c.shape)}")
    out = torch.empty_like(G)
    lib, _ = _build.load_library()
    with torch.cuda.device(G.device):
        err = lib.flvis_attitude_chain(q0.data_ptr(), G.data_ptr(), a_unit.data_ptr(),
                                       c.data_ptr(), out.data_ptr(), 1, P,
                                       _build.stream_of(G))
    _build.check_launch("attitude_chain", err)
    attitude_chain_kernel.launches += 1
    return out


attitude_chain_kernel.launches = 0


def attitude_chain(q0, G, a_unit, c):
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (which raises on what it cannot take)."""
    if G.is_cuda:
        return attitude_chain_kernel(q0, G, a_unit, c)
    if G.device.type == "cpu":
        return attitude_chain_plain(q0, G, a_unit, c)
    raise ValueError(f"attitude_chain: unsupported device {G.device}")
