"""The IMU packet on the card: the sequential Madgwick attitude recurrence
of one IMU packet,

    q_k = normalize( (q_{k-1} ⊗ G_k) ⊗ exp(c_k · a_k × ĝ(q_{k-1} ⊗ G_k)) ),

with ĝ(q) = R(q)ᵀ ẑ the predicted gravity direction in the IMU frame, and
the whole packet around it.

Replaces the TPU kernel flvis_tpu/ops/pallas/imu_chain.py:attitude_chain_pallas
(called from vio/vimotion._feed_prop_batch on every IMU packet once the
filter is initialised, i.e. on every VIO frame).  csrc/imu_chain.cu holds
two entries that share the recurrence:

- `attitude_chain_kernel`, the TPU kernel's own function (q0, G, a_unit,
  c → the P attitudes), one thread per chain;
- `imu_feed_kernel`, the whole packet — vio/vimotion.imu_feed_batch from
  one VioState to the next, steady and init mode alike, the mode read from
  `initialized` on the card — in one launch with no host read.  It is what
  the VIO path runs; `imu_feed_plain`'s counterpart is
  vimotion.imu_feed_batch_plain.

On the H100 both are latency-bound: a 16-sample packet is ~0.5 KB in and
~1.3k flops, and the fused kernel's ring is ~27 KB, so the bound is a
launch and the chain's dependent latency, not bytes or operations.  The
fused kernel stages a chunk of 32 samples with one load per lane, forms
everything that does not depend on q in parallel, and runs the recurrence
on one lane from shared memory, each sample's row one step behind; its
other warps copy the old ring into the new one before the packet's rows
land.  The C entries take a batch of B
chains (one per sequence, as a multi-sequence caller would need); the
wrappers pass B = 1.  Like the TPU kernel the chain uses the 2nd-order
small-angle series for the correction exp (cw = 1 − θ²/8,
s = ½(1 − θ²/24)); |θ| ≤ 10·β·dt ≈ 0.025 rad there, so the series error is
~1e-7 after renormalising, and the kernels are held to the plain versions
(exact exp) at 1e-6 on the attitude.

Both wrappers count their launches in `attitude_chain_kernel.launches`
(the count of the imu_chain source's kernels, which a VIO path reads);
`imu_feed_kernel.launches` counts the fused launches alone.
"""

from __future__ import annotations

import ctypes

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


# The VioState fields the fused kernel reads and writes, in its order.
FEED_FIELDS = ("t", "pos", "vel", "q", "acc", "gyro", "head", "count", "bias_acc",
               "bias_gyro", "initialized", "init_acc_sum", "init_gyro_sum", "init_count")
_FEED_INT = {"head", "count", "init_count"}


def imu_feed_kernel(fields, acc, gyro, t, valid, *, init_samples: int, gravity: float,
                    madgwick_beta: float):
    """Launch csrc/imu_chain.cu's fused feed on CUDA tensors: `fields`, the
    VioState's FEED_FIELDS in order (float32 ring rows (C,), (C, 3),
    (C, 4); int32 and bool scalars), and the packet acc (P, 3), gyro (P, 3),
    t (P,), valid (P,) bool or None (all valid).  Returns the new fields,
    fresh tensors; the inputs are not touched."""
    named = dict(zip(FEED_FIELDS, fields))
    C = named["t"].shape[0] if named["t"].dim() == 1 else -1
    P = t.shape[0] if t.dim() == 1 else -1
    want = {"t": (C,), "pos": (C, 3), "vel": (C, 3), "q": (C, 4), "acc": (C, 3),
            "gyro": (C, 3), "bias_acc": (3,), "bias_gyro": (3,), "init_acc_sum": (3,),
            "init_gyro_sum": (3,)}
    if (len(fields) != len(FEED_FIELDS) or C < 1 or P < 1
            or any(tuple(named[k].shape) != s for k, s in want.items())
            or any(named[k].shape != () for k in (*_FEED_INT, "initialized"))
            or acc.shape != (P, 3) or gyro.shape != (P, 3)
            or (valid is not None and valid.shape != (P,))):
        raise ValueError("imu_feed: expected the VioState ring (C,), (C, 3), (C, 4), scalars, "
                         "and a packet acc (P, 3), gyro (P, 3), t (P,), valid (P,) with "
                         f"P >= 1; got C={C}, acc {tuple(acc.shape)}, gyro "
                         f"{tuple(gyro.shape)}, t {tuple(t.shape)}")
    floats = {f"state.{k}": v for k, v in named.items()
              if k not in _FEED_INT and k != "initialized"}
    _build.require_cuda_f32("imu_feed", acc=acc, gyro=gyro, t=t, **floats)
    dev = t.device
    for k in _FEED_INT:
        if named[k].dtype != torch.int32 or named[k].device != dev:
            raise ValueError(f"imu_feed: {k} must be an int32 tensor on {dev}")
    for k, v in (("initialized", named["initialized"]), ("valid", valid)):
        if v is not None and (v.dtype != torch.bool or v.device != dev
                              or not v.is_contiguous()):
            raise ValueError(f"imu_feed: {k} must be a contiguous bool tensor on {dev}")
    out = tuple(torch.empty_like(v) for v in fields)
    ptrs = [v.data_ptr() for v in fields] + [acc.data_ptr(), gyro.data_ptr(), t.data_ptr(),
                                             0 if valid is None else valid.data_ptr()]
    ptrs += [v.data_ptr() for v in out]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    lib, _ = _build.load_library()
    err = _build.launch_on(dev.index, lib.flvis_imu_feed, arr, len(ptrs), 1, C, P,
                           int(init_samples), float(gravity), float(10.0 * madgwick_beta),
                           _build.stream_of(t))
    _build.check_launch("imu_feed", err)
    imu_feed_kernel.launches += 1
    attitude_chain_kernel.launches += 1
    return out


imu_feed_kernel.launches = 0


def attitude_chain(q0, G, a_unit, c):
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (which raises on what it cannot take)."""
    if G.is_cuda:
        return attitude_chain_kernel(q0, G, a_unit, c)
    if G.device.type == "cpu":
        return attitude_chain_plain(q0, G, a_unit, c)
    raise ValueError(f"attitude_chain: unsupported device {G.device}")
