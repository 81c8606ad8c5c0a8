"""schur_step: one damped Schur-complement Levenberg-Marquardt step of the
sliding-window BA.

Replaces the TPU kernel flvis_tpu/ops/pallas/schur.py:schur_step_kernel
(routed from window_ba._schur_step, window_ba.py:356-372), with the same
inputs and outputs: R (W, 9), t (W, 3), pw (3, L), obs3 (3W, L) rows
[u, v, u_r] per pose, urv / wm (W, L) float masks, fixed (W,) float,
cam_row (5,) [fx, fy, cx, cy, fx·b], lam () — all float32 — and the static
Huber threshold delta → dp (W, 6), dl (3, L).

What bounds it on the H100: at W=10, L=1024 the step is ~2 MFLOP and
~0.3 MB of inputs, so it is bound by latency, not by flops or bytes — a
chain of dependent reductions ending in a 60×60 solve.  The design
(csrc/schur.cu) is two launches on the current stream behind one C entry:
  (1) one block per tile of 16 landmarks (64 blocks at L=1024), one thread
      per (pose, landmark) pair: stereo residuals, Huber weights and
      Jacobians; Hll/bl summed over the poses in shared memory, the damped
      closed-form 3×3 inverse and A = Hpl·Hll⁻¹; the tile's share of the
      reduced system (the upper block triangle of Hpp − A·Hplᵀ, bp − A·bl
      and the Hpp diagonal) in shared memory.  Clusters of 8 blocks sum
      their tiles through distributed shared memory; the last block to
      finish sums the cluster partials, adds the damping and the gauge
      identity block, and solves the ≤96×96 system by 6×6 block Gaussian
      elimination without pivoting (closed-form 6×6 block inverses, as
      flvis_tpu/ops/linalg.py:block_spd_solve) in double precision in
      shared memory — the float32 plain path is the noisier side.  A
      diagonal block without an inverse (non-positive or non-finite
      determinant) is left out and its pose gets dp = 0; an unobserved pose
      or an empty slot of a window with count < 3 keeps a positive,
      damped diagonal and gets dp = 0 exactly, as the plain solve gives;
  (2) the same tiles recompute their Jacobians, Hll and bl and write
      dl = Hll⁻¹(bl − Hplᵀ dp).
Every sum runs in a fixed order and no float atomics are used, so results
repeat bit for bit from run to run.  The TPU's single-program unrolled
form is not carried over: blocks on Hopper run in parallel, so the
cross-tile sums go through shared memory of a cluster and a
last-block-done pass.  The last block is found by an integer ticket that
belongs to the stream (`_ticket`): zeroed once, reset by the last block of
every call, so calls on one stream follow each other and calls on
different streams never share it.
Windows of more than 16 poses are refused (the solve's shared memory is
sized for 96 unknowns, as the TPU kernel's routing limit W ≤ 16).
"""

from __future__ import annotations

import torch

from . import _build

MAX_WINDOW = 16
_TICKETS: dict = {}     # (device index, raw stream) -> the stream's uint32 ticket


def schur_step_plain(R, t, pw, obs3, urv, wm, fixed, cam_row, lam, delta: float):
    """Plain PyTorch version: the XLA body of window_ba._schur_step
    (window_ba.py:373-431) on the kernel's argument layout."""
    W, L = wm.shape
    fx, fy, cx, cy, fxb = cam_row.unbind(0)
    Rm = R.reshape(W, 3, 3)
    ur_valid = urv > 0.5
    w_mask = wm > 0.5
    fixed_pose = fixed > 0.5
    p_c = torch.einsum("wab,bl->wal", Rm, pw) + t[:, :, None]
    x, y, zr = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    z = torch.where(torch.abs(zr) < 1e-6, 1e-6, zr)
    u = fx * x / z + cx
    v = fy * y / z + cy
    obs = obs3.reshape(W, 3, L)
    r = torch.stack([u - obs[:, 0], v - obs[:, 1],
                     torch.where(ur_valid, u - fxb / z - obs[:, 2], 0.0)], dim=1)

    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    one = torch.ones_like(iz)
    urm = urv
    duv = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], 1),
        torch.stack([zero, fy * iz, -fy * y * iz2], 1),
        torch.stack([fx * iz * urm, zero, (-fx * x * iz2 + fxb * iz2) * urm], 1),
    ], dim=1)                                                 # (W, 3row, 3xyz, L)
    dp_pose = torch.stack([
        torch.stack([one, zero, zero, zero, zr, -y], 1),
        torch.stack([zero, one, zero, -zr, zero, x], 1),
        torch.stack([zero, zero, one, y, -x, zero], 1),
    ], dim=1)                                                 # (W, 3xyz, 6, L)
    Jp = torch.sum(duv[:, :, :, None, :] * dp_pose[:, None, :, :, :], dim=2)
    Jl = torch.einsum("wacl,wcb->wabl", duv, Rm)

    rn = torch.sqrt(torch.clamp(torch.sum(r * r, dim=1), min=1e-12))
    wgt = torch.where(w_mask, torch.where(rn <= delta, 1.0, delta / rn), 0.0)
    Jp = torch.where(fixed_pose[:, None, None, None], 0.0, Jp)

    Jpw = Jp * wgt[:, None, None, :]
    Hpp = torch.einsum("wakl,waml->wkm", Jpw, Jp)
    Hll = torch.einsum("wabl,wl,wacl->bcl", Jl, wgt, Jl)
    Hpl = torch.einsum("wakl,wabl->wkbl", Jpw, Jl)
    bp = -torch.einsum("wakl,wal->wk", Jpw, r)
    bl = -torch.einsum("wabl,wl,wal->bl", Jl, wgt, r)

    eye3 = torch.eye(3, dtype=pw.dtype, device=pw.device)
    damp = lam * torch.clamp((Hll[0, 0] + Hll[1, 1] + Hll[2, 2]) / 3.0, min=1e-6) + 1e-8
    Hll_inv = sym3_inv(Hll + damp * eye3[:, :, None])

    A = torch.einsum("wkml,mnl->wknl", Hpl, Hll_inv)
    S_red = torch.einsum("wknl,vmnl->wvkm", A, Hpl)
    tr = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    eye6 = torch.eye(6, dtype=pw.dtype, device=pw.device)
    Hpp_d = Hpp + (lam * eye6)[None] * torch.clamp(tr[:, None, None] / 6.0, min=1e-6)
    S = -S_red
    idx = torch.arange(W, device=pw.device)
    S[idx, idx] = S[idx, idx] + Hpp_d
    S = S.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    rhs = bp - torch.einsum("wknl,nl->wk", A, bl)

    fixmat = fixed_pose.repeat_interleave(6)
    S = torch.where(fixmat[:, None] | fixmat[None, :], 0.0, S)
    S = S + torch.diag(torch.where(fixmat, 1.0, 1e-9))
    rhs = torch.where(fixed_pose[:, None], 0.0, rhs)
    dp = torch.linalg.solve(S, rhs.reshape(-1)).reshape(W, 6)
    dl = torch.einsum("bcl,cl->bl", Hll_inv, bl - torch.einsum("wkcl,wk->cl", Hpl, dp))
    return dp, dl


def sym3_inv(H):
    """Closed-form inverse of symmetric (3, 3, L) blocks."""
    a, b, c = H[0, 0], H[0, 1], H[0, 2]
    d, e, f = H[1, 1], H[1, 2], H[2, 2]
    A00 = d * f - e * e
    A01 = c * e - b * f
    A02 = b * e - c * d
    A11 = a * f - c * c
    A12 = b * c - a * e
    A22 = a * d - b * b
    det = a * A00 + b * A01 + c * A02
    idet = torch.where(torch.abs(det) > 1e-20, 1.0 / det, 0.0)
    return torch.stack([torch.stack([A00, A01, A02]), torch.stack([A01, A11, A12]),
                        torch.stack([A02, A12, A22])]) * idet


def schur_step_kernel(R, t, pw, obs3, urv, wm, fixed, cam_row, lam, delta: float):
    """Launch csrc/schur.cu's two passes on the current stream."""
    _build.require_cuda_f32("schur_step", R=R, t=t, pw=pw, obs3=obs3, urv=urv, wm=wm,
                            fixed=fixed, cam_row=cam_row, lam=lam)
    W, L = wm.shape
    expect = {"R": (W, 9), "t": (W, 3), "pw": (3, L), "obs3": (3 * W, L),
              "urv": (W, L), "fixed": (W,), "cam_row": (5,), "lam": ()}
    got = {"R": R, "t": t, "pw": pw, "obs3": obs3, "urv": urv, "fixed": fixed,
           "cam_row": cam_row, "lam": lam}
    for name, shape in expect.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"schur_step: {name} has shape {tuple(got[name].shape)}, "
                             f"expected {shape}")
    if not 1 <= W <= MAX_WINDOW or L < 1:
        raise ValueError(f"schur_step: window {W} not in [1, {MAX_WINDOW}] or L={L} < 1")
    lib, _ = _build.load_library()
    stream = _build.stream_of(pw)
    scratch = torch.empty(lib.flvis_schur_scratch_floats(W, L), dtype=torch.float32,
                          device=pw.device)
    dp = torch.empty((W, 6), dtype=torch.float32, device=pw.device)
    dl = torch.empty((3, L), dtype=torch.float32, device=pw.device)
    with torch.cuda.device(pw.device):
        err = lib.flvis_schur_step(
            R.data_ptr(), t.data_ptr(), pw.data_ptr(), obs3.data_ptr(), urv.data_ptr(),
            wm.data_ptr(), fixed.data_ptr(), cam_row.data_ptr(), lam.data_ptr(),
            float(delta), W, L, scratch.data_ptr(), _ticket(pw.device, stream).data_ptr(),
            dp.data_ptr(), dl.data_ptr(), stream)
    _build.check_launch("schur_step", err)
    schur_step_kernel.launches += 1
    return dp, dl


schur_step_kernel.launches = 0


def _ticket(device, stream: int):
    """The last-block ticket of `stream` on `device`: made zero on that
    stream at its first use; every call leaves it 0 again."""
    key = (device.index, stream)
    ticket = _TICKETS.get(key)
    if ticket is None:
        ticket = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return ticket


def schur_step(R, t, pw, obs3, urv, wm, fixed, cam_row, lam, delta: float):
    """→ (dp (W, 6), dl (3, L)).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (which raises on what it cannot take)."""
    if pw.is_cuda:
        return schur_step_kernel(R, t, pw, obs3, urv, wm, fixed, cam_row, lam, delta)
    if pw.device.type == "cpu":
        return schur_step_plain(R, t, pw, obs3, urv, wm, fixed, cam_row, lam, delta)
    raise ValueError(f"schur_step: unsupported device {pw.device}")
