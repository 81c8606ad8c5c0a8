"""Sliding-window structure-and-motion bundle adjustment
(port of flvis_tpu/backend/window_ba.py).

A ring of W keyframe poses (oldest valid one fixed as the gauge), an L-slot
landmark table keyed by global id, and a dense masked (W, L) observation
matrix; Levenberg-Marquardt with the landmark blocks eliminated by a Schur
complement, scheduled optimize(iters1) → chi² cull → optimize(iters2), and
a Correction exported for the tracker.  Per-landmark tensors keep the
landmark axis last, as in the reference.

Each LM step is ops/kernels/schur.schur_step (the CUDA kernel on a CUDA
window, the plain version on a CPU one).  The reference's while_loop
(window_ba.py:434-470) keeps its accept / λ / `done` semantics here with one
host read of `done` per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import BackendConfig

from ..geometry import se3 as se3m, so3
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3
from ..ops.kernels.schur import schur_step
from ..frontend.landmark_table import free_slot_order, scatter_rows


@dataclasses.dataclass(frozen=True)
class WindowState:
    kf_q: torch.Tensor          # (W, 4) T_c_w rotation
    kf_t: torch.Tensor          # (W, 3)
    kf_frame_id: torch.Tensor   # (W,) int32, -1 = empty
    kf_valid: torch.Tensor      # (W,) bool
    lm_pw: torch.Tensor         # (L, 3)
    lm_id: torch.Tensor         # (L,) int32, -1 = empty
    lm_valid: torch.Tensor      # (L,) bool
    obs_uv: torch.Tensor        # (W, L, 2)
    obs_ur: torch.Tensor        # (W, L) right-image u for stereo residuals
    obs_ur_valid: torch.Tensor  # (W, L) bool
    obs_valid: torch.Tensor     # (W, L) bool
    head: torch.Tensor          # int32 ring position
    count: torch.Tensor         # int32 keyframes added (saturating at W)

    @property
    def window(self) -> int:
        return self.kf_q.shape[0]

    @property
    def capacity(self) -> int:
        return self.lm_pw.shape[0]

    def poses(self) -> SE3:
        return SE3(self.kf_q, self.kf_t)


class KeyframePacket(NamedTuple):
    """A keyframe as the tracker publishes it to the backend."""

    frame_id: torch.Tensor    # int32
    q: torch.Tensor           # (4,) T_c_w
    t: torch.Tensor           # (3,)
    lm_id: torch.Tensor       # (N,) int32
    lm_uv: torch.Tensor       # (N, 2)
    lm_ur: torch.Tensor       # (N,) right-image u
    lm_ur_mask: torch.Tensor  # (N,) bool
    lm_pw: torch.Tensor       # (N, 3)
    lm_mask: torch.Tensor     # (N,) bool


class Correction(NamedTuple):
    """Backend feedback: corrected newest-keyframe pose, multi-view landmark
    positions and outlier ids."""

    frame_id: torch.Tensor
    q: torch.Tensor
    t: torch.Tensor
    lm_id: torch.Tensor       # (L,) int32 (-1 padding)
    lm_pw: torch.Tensor       # (L, 3)
    lm_mask: torch.Tensor     # (L,) bool
    outlier_id: torch.Tensor  # (L,) int32 (-1 padding)
    outlier_mask: torch.Tensor
    valid: torch.Tensor       # bool — window ready and optimized


def null_correction(cfg: BackendConfig, *, device, dtype=torch.float32) -> Correction:
    """A valid=False Correction of the backend's shapes."""
    l = cfg.max_landmarks
    return Correction(
        frame_id=torch.tensor(-1, dtype=torch.int32, device=device),
        q=torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=device),
        t=torch.zeros(3, dtype=dtype, device=device),
        lm_id=torch.full((l,), -1, dtype=torch.int32, device=device),
        lm_pw=torch.zeros((l, 3), dtype=dtype, device=device),
        lm_mask=torch.zeros(l, dtype=torch.bool, device=device),
        outlier_id=torch.full((l,), -1, dtype=torch.int32, device=device),
        outlier_mask=torch.zeros(l, dtype=torch.bool, device=device),
        valid=torch.zeros((), dtype=torch.bool, device=device))


def _empty(w: int, l: int, device, dtype) -> WindowState:
    kf_q = torch.zeros((w, 4), dtype=dtype, device=device)
    kf_q[:, 0] = 1.0
    return WindowState(
        kf_q=kf_q, kf_t=torch.zeros((w, 3), dtype=dtype, device=device),
        kf_frame_id=torch.full((w,), -1, dtype=torch.int32, device=device),
        kf_valid=torch.zeros(w, dtype=torch.bool, device=device),
        lm_pw=torch.zeros((l, 3), dtype=dtype, device=device),
        lm_id=torch.full((l,), -1, dtype=torch.int32, device=device),
        lm_valid=torch.zeros(l, dtype=torch.bool, device=device),
        obs_uv=torch.zeros((w, l, 2), dtype=dtype, device=device),
        obs_ur=torch.zeros((w, l), dtype=dtype, device=device),
        obs_ur_valid=torch.zeros((w, l), dtype=torch.bool, device=device),
        obs_valid=torch.zeros((w, l), dtype=torch.bool, device=device),
        head=torch.tensor(0, dtype=torch.int32, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device))


def empty(cfg: BackendConfig, *, device, dtype=torch.float32) -> WindowState:
    return _empty(cfg.window_size, cfg.max_landmarks, device, dtype)


def reset(cfg: BackendConfig, state: WindowState) -> WindowState:
    """Full wipe (shape taken from `state`)."""
    return _empty(state.window, state.capacity, state.lm_pw.device, state.lm_pw.dtype)


def _set_row(a, i, v):
    return a.index_copy(0, i.reshape(1).long(), v.reshape((1,) + a.shape[1:]).to(a.dtype))


def add_keyframe(cfg: BackendConfig, state: WindowState, kf: KeyframePacket) -> WindowState:
    """Ring-insert a keyframe (overwriting the oldest slot), merge its
    landmark observations by id, allocate slots for new ids, and free the
    landmarks the slide orphaned."""
    w = state.window
    L = state.capacity
    slot = state.head
    dev = state.lm_pw.device
    f = torch.zeros((), dtype=torch.bool, device=dev)
    state = dataclasses.replace(
        state,
        kf_q=_set_row(state.kf_q, slot, kf.q),
        kf_t=_set_row(state.kf_t, slot, kf.t),
        kf_frame_id=_set_row(state.kf_frame_id, slot, kf.frame_id),
        kf_valid=_set_row(state.kf_valid, slot, ~f),
        head=((state.head + 1) % w).to(torch.int32),
        count=torch.clamp(state.count + 1, max=w).to(torch.int32))

    eq = (kf.lm_id[:, None] == state.lm_id[None, :]) & state.lm_valid[None, :] \
        & kf.lm_mask[:, None]
    match_slot = torch.argmax(eq.to(torch.int32), dim=1)
    has_match = torch.any(eq, dim=1)

    need = kf.lm_mask & ~has_match
    free_slots = free_slot_order(state.lm_valid)
    need_rank = torch.cumsum(need.to(torch.int64), 0) - 1
    num_free = torch.sum(~state.lm_valid)
    can_alloc = need & (need_rank < num_free)
    alloc_slot = free_slots[torch.clamp(need_rank, 0, L - 1)]
    tgt = torch.where(has_match, match_slot, torch.where(can_alloc, alloc_slot, L))
    use = kf.lm_mask & (has_match | can_alloc)
    dump = torch.full_like(tgt, L)
    at_use = torch.where(use, tgt, dump)

    lm_pw = scatter_rows(state.lm_pw, torch.where(can_alloc & use, tgt, dump), kf.lm_pw)
    lm_id = scatter_rows(state.lm_id, at_use, kf.lm_id)
    lm_valid = scatter_rows(state.lm_valid, at_use, ~f)

    def fresh_row(like, src, at):
        return scatter_rows(torch.zeros_like(like), at, src)

    obs_row_uv = fresh_row(state.obs_uv[0], kf.lm_uv, at_use)
    obs_row_valid = fresh_row(state.obs_valid[0], ~f, at_use)
    obs_row_ur = fresh_row(state.obs_ur[0], kf.lm_ur, at_use)
    obs_row_ur_valid = fresh_row(state.obs_ur_valid[0], ~f,
                                 torch.where(use & kf.lm_ur_mask, tgt, dump))
    obs_uv = _set_row(state.obs_uv, slot, obs_row_uv)
    obs_valid = _set_row(state.obs_valid, slot, obs_row_valid)
    obs_ur = _set_row(state.obs_ur, slot, obs_row_ur)
    obs_ur_valid = _set_row(state.obs_ur_valid, slot, obs_row_ur_valid)

    lm_valid = lm_valid & (torch.sum(obs_valid, dim=0) > 0)
    obs_valid = obs_valid & lm_valid[None, :]
    return dataclasses.replace(
        state, lm_pw=lm_pw, lm_id=lm_id, lm_valid=lm_valid, obs_uv=obs_uv,
        obs_valid=obs_valid, obs_ur=obs_ur, obs_ur_valid=obs_ur_valid & obs_valid)


def _residuals(cam: StereoCamera, poses: SE3, lm_pw, obs_uv, obs_ur, ur_valid):
    """(W, 3, L) stereo residuals [Δu_l, Δv, Δu_r] (the right-camera row is
    zero where no stereo measurement exists)."""
    R = so3.to_matrix(poses.q)
    p_c = torch.einsum("wab,bl->wal", R, lm_pw.T) + poses.t[:, :, None]
    z = torch.where(torch.abs(p_c[:, 2]) < 1e-6, 1e-6, p_c[:, 2])
    u = cam.fx * p_c[:, 0] / z + cam.cx
    v = cam.fy * p_c[:, 1] / z + cam.cy
    ur_pred = u - cam.fx * cam.baseline / z
    return torch.stack([u - obs_uv[..., 0], v - obs_uv[..., 1],
                        torch.where(ur_valid, ur_pred - obs_ur, 0.0)], dim=1)


def _total_cost(r, w_mask, delta):
    r2 = torch.sum(r * r, dim=1)
    rn = torch.sqrt(torch.clamp(r2, min=1e-12))
    rho = torch.where(rn <= delta, 0.5 * r2, delta * (rn - 0.5 * delta))
    return torch.sum(torch.where(w_mask, rho, 0.0))


def _schur_consts(cam: StereoCamera, obs, w_mask, fixed_pose):
    """The Schur step's loop-invariant kernel arguments (obs3, urv, wm,
    fixed, cam_row), built once per _lm_loop call."""
    obs_uv, obs_ur, ur_valid = obs
    W, L = w_mask.shape
    f32 = torch.float32
    obs3 = torch.stack([obs_uv[..., 0], obs_uv[..., 1], obs_ur], dim=1).reshape(3 * W, L)
    cam_row = torch.stack([cam.fx, cam.fy, cam.cx, cam.cy, cam.fx * cam.baseline])
    return (obs3.contiguous(), ur_valid.to(f32), w_mask.to(f32), fixed_pose.to(f32),
            cam_row.to(f32))


def _schur_step(poses: SE3, lm_pw, consts, lam, delta):
    """One damped Schur LM step through ops/kernels/schur.schur_step, with
    `consts` = _schur_consts(...) of the window.  Returns (new_poses,
    new_lm_pw)."""
    obs3, urv, wm, fixed, cam_row = consts
    W = wm.shape[0]
    R = so3.to_matrix(poses.q).reshape(W, 9).contiguous()
    dp, dl = schur_step(R, poses.t.contiguous(), lm_pw.T.contiguous(), obs3, urv, wm, fixed,
                        cam_row, lam.to(torch.float32), float(delta))
    return se3m.retract_left(poses, dp), lm_pw + dl.T


def _lm_loop(cam, poses, lm_pw, obs, w_mask, fixed_pose, iters: int, delta):
    obs_uv, obs_ur, ur_valid = obs
    consts = _schur_consts(cam, obs, w_mask, fixed_pose)
    cost = _total_cost(_residuals(cam, poses, lm_pw, obs_uv, obs_ur, ur_valid), w_mask,
                       delta)
    lam = torch.tensor(1e-4, dtype=cost.dtype, device=cost.device)
    for _ in range(iters):
        new_poses, new_lm = _schur_step(poses, lm_pw, consts, lam, delta)
        new_cost = _total_cost(_residuals(cam, new_poses, new_lm, obs_uv, obs_ur,
                                          ur_valid), w_mask, delta)
        better = new_cost < cost
        poses = se3m.where(better, new_poses, poses)
        lm_pw = torch.where(better, new_lm, lm_pw)
        lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e3))
        # Converged: an accepted step improved the cost by < 1e-5 relative.
        done = better & (cost - new_cost < 1e-5 * cost)
        cost = torch.where(better, new_cost, cost)
        if bool(done):
            break
    return poses, lm_pw, cost


class BAResult(NamedTuple):
    state: WindowState
    correction: Correction
    cost: torch.Tensor
    num_obs: torch.Tensor


def optimize(cfg: BackendConfig, cam: StereoCamera, state: WindowState) -> BAResult:
    """Two-phase windowed BA and its Correction.  Like the reference, the
    solve always runs but its result is kept only once the window holds
    ≥ 3 keyframes (Correction.valid)."""
    poses = state.poses()
    w_mask = state.obs_valid & state.kf_valid[:, None] & state.lm_valid[None, :]
    big = torch.iinfo(torch.int32).max
    fid = torch.where(state.kf_valid, state.kf_frame_id, big)
    fixed_pose = torch.arange(state.window, device=fid.device) == torch.argmin(fid)

    obs = (state.obs_uv, state.obs_ur, state.obs_ur_valid & w_mask)
    poses1, lm1, _ = _lm_loop(cam, poses, state.lm_pw, obs, w_mask, fixed_pose,
                              cfg.iters1, cfg.huber_delta)
    r1 = _residuals(cam, poses1, lm1, *obs)
    w_mask2 = w_mask & (torch.sum(r1 * r1, dim=1) < cfg.chi2_cull)
    obs2 = (state.obs_uv, state.obs_ur, state.obs_ur_valid & w_mask2)
    poses2, lm2, cost = _lm_loop(cam, poses1, lm1, obs2, w_mask2, fixed_pose,
                                 cfg.iters2, cfg.huber_delta)

    ready = state.count >= 3
    poses_out = se3m.where(ready, poses2, poses)
    lm_out = torch.where(ready, lm2, state.lm_pw)
    views_before = torch.sum(w_mask, dim=0)
    views_after = torch.sum(w_mask2, dim=0)
    outlier = state.lm_valid & (views_before > 0) & (views_after == 0) & ready
    lm_valid_new = state.lm_valid & ~outlier
    new_state = dataclasses.replace(
        state, kf_q=poses_out.q, kf_t=poses_out.t, lm_pw=lm_out,
        obs_valid=torch.where(ready, state.obs_valid & w_mask2, state.obs_valid),
        lm_valid=lm_valid_new)

    newest = ((state.head - 1) % state.window).reshape(1).long()
    multiview = lm_valid_new & (views_after >= cfg.min_views)
    minus1 = torch.full_like(state.lm_id, -1)
    corr = Correction(
        frame_id=state.kf_frame_id.index_select(0, newest)[0],
        q=poses_out.q.index_select(0, newest)[0],
        t=poses_out.t.index_select(0, newest)[0],
        lm_id=torch.where(multiview, state.lm_id, minus1),
        lm_pw=lm_out, lm_mask=multiview,
        outlier_id=torch.where(outlier, state.lm_id, minus1),
        outlier_mask=outlier, valid=ready)
    return BAResult(new_state, corr, cost, torch.sum(w_mask2))
