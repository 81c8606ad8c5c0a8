"""Frame-to-frame tracking state machine — the frontend hot loop
(port of flvis_tpu/frontend/tracker.py).

Per frame: gradient pyramids of the (previous, left, right) stack → LK with
a pose-prior guess → fundamental-matrix RANSAC gate → two-start motion BA
→ median+MAD gate (with a PnP RANSAC rescue on starvation) → redetection
into free slots → stereo/triangulated depth innovation → keyframe decision.

Choices made where the JAX formulation cannot carry over as is:
  - Random draws.  The reference folds the frame id into PRNGKey(7) and
    splits it into ransac/depth/pnp keys (tracker.py:331,516); the init
    branch hands the unsplit key to the depth step (tracker.py:297).  A
    torch generator cannot give those bits, so `track_frame` takes an
    optional `Draws` record with the same shapes (uniform scores for the F
    and PnP RANSACs, dummy depths); without it the draws come from the
    caller's torch.Generator.  Parity tests pass JAX's own draws in.
  - Branches.  The lax.conds on the tracking status (tracker.py:573) and on
    PnP rescue (tracker.py:423) are host branches here (one device→host
    read each).  They are the two points that block capturing the frame
    step as one CUDA graph.  The remaining selects stay torch.where.
  - Medians.  jnp.nanmedian averages the two middle values, torch.nanmedian
    returns the lower one: torch.nanquantile(x, 0.5) is used instead.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..config import FrontendConfig

from ..backend import motion_ba
from ..backend.window_ba import KeyframePacket
from ..geometry import camera as cam_m, se3 as se3m, so3, triangulation
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3
from ..ops import features as feat_ops
from ..ops import image as imops
from ..ops import lk as lk_ops
from ..ops import pnp as pnp_ops
from ..ops import ransac as ransac_ops
from ..utils.tree import tree_map, tree_where
from . import landmark_table as lt

STATUS_UNINIT = 0
STATUS_TRACKING = 1
STATUS_FAIL = 2
RING = 64


@dataclasses.dataclass(frozen=True)
class TrackerState:
    table: lt.LandmarkTable
    T_c_w: SE3                  # current camera-from-world pose
    T_prev: SE3                 # previous frame pose
    velocity: torch.Tensor      # (6,) twist log(T_k ∘ T_{k-1}⁻¹)
    img_prev: torch.Tensor      # previous left image (equalized), (H, W)
    status: torch.Tensor        # int32: 0 uninit / 1 tracking / 2 fail
    frame_id: torch.Tensor      # int32
    next_lm_id: torch.Tensor    # int32 (ids start at 100)
    last_kf_T: SE3
    kf_count: torch.Tensor      # int32
    frames_since_kf: torch.Tensor
    ring_q: torch.Tensor        # (R, 4) pose ring for late corrections
    ring_t: torch.Tensor        # (R, 3)
    ring_fid: torch.Tensor      # (R,) int32 frame id, -1 empty
    ring_head: torch.Tensor     # int32
    fail_count: torch.Tensor    # int32 consecutive failed frames
    recover_count: torch.Tensor  # int32 recovery attempts since last success


class FrameOutput(NamedTuple):
    T_c_w: SE3
    is_keyframe: torch.Tensor
    reset_backend: torch.Tensor
    num_inliers: torch.Tensor
    mean_reproj_err: torch.Tensor
    status: torch.Tensor


class Draws(NamedTuple):
    """One frame's random draws (shapes of the reference's jax.random calls)."""

    ransac: torch.Tensor   # (ransac_hypotheses, num_slots) uniform [0, 1)
    pnp: torch.Tensor      # (ransac_hypotheses, num_slots) uniform [0, 1)
    depth: torch.Tensor    # (num_slots,) uniform dummy depths in dummy_depth_range


def make_draws(cfg: FrontendConfig, generator: torch.Generator, device) -> Draws:
    h, n = cfg.ransac_hypotheses, cfg.num_slots
    lo, hi = cfg.dummy_depth_range
    u = torch.rand(2 * h * n + n, generator=generator, device=device)
    return Draws(u[:h * n].view(h, n), u[h * n:2 * h * n].view(h, n),
                 lo + (hi - lo) * u[2 * h * n:])


def _i32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def init_state(cfg: FrontendConfig, *, device, dtype=torch.float32) -> TrackerState:
    I = se3m.identity(dtype=dtype, device=device)
    ring_q = torch.zeros((RING, 4), dtype=dtype, device=device)
    ring_q[:, 0] = 1.0
    return TrackerState(
        table=lt.empty(cfg.num_slots, device=device, dtype=dtype),
        T_c_w=I, T_prev=I,
        velocity=torch.zeros(6, dtype=dtype, device=device),
        img_prev=torch.zeros((cfg.height, cfg.width), dtype=dtype, device=device),
        status=_i32(STATUS_UNINIT, device),
        frame_id=_i32(0, device),
        next_lm_id=_i32(100, device),
        last_kf_T=I,
        kf_count=_i32(0, device),
        frames_since_kf=_i32(0, device),
        ring_q=ring_q,
        ring_t=torch.zeros((RING, 3), dtype=dtype, device=device),
        ring_fid=torch.full((RING,), -1, dtype=torch.int32, device=device),
        ring_head=_i32(0, device),
        fail_count=_i32(0, device),
        recover_count=_i32(0, device),
    )


def _detect_params(cfg: FrontendConfig) -> feat_ops.DetectParams:
    return feat_ops.DetectParams(
        grid_rows=cfg.grid_rows, grid_cols=cfg.grid_cols, per_cell=cfg.per_cell,
        min_distance=cfg.min_distance, quality_level=cfg.quality_level,
        margin=cfg.margin)


def _lk_params(cfg: FrontendConfig) -> lk_ops.LKParams:
    return lk_ops.LKParams(radius=cfg.lk_radius, num_levels=cfg.pyramid_levels,
                           iters=cfg.lk_iters, min_eig=cfg.lk_min_eig)


def _nanmedian(x, dim=None):
    return torch.nanquantile(x, 0.5) if dim is None else torch.nanquantile(x, 0.5, dim=dim)


def _measure_depth(cfg: FrontendConfig, cam: StereoCamera, pyr0, pyr1, d_img,
                   table: lt.LandmarkTable, T_c_w: SE3):
    """Depth for all active slots: stereo LK + rectified disparity (or the
    depth image in depth mode), with motion triangulation from the first
    observation as the fallback.  Returns (z, ok, stereo_ok)."""
    if cfg.depth_mode:
        z = imops.bilinear_sample(d_img, table.uv) / cam.depth_factor
        ok = table.active & (z > cfg.depth_min) & (z < cfg.depth_max)
        return z, ok, ok

    p_c = se3m.transform_points(T_c_w, table.p_w)
    z3d = torch.where(table.has_3d & table.active, p_c[:, 2], torch.nan)
    z_med = torch.nan_to_num(_nanmedian(z3d), nan=4.0)
    z_prior = torch.where(table.has_3d, p_c[:, 2], z_med)
    disp_guess = cam.fx * cam.baseline / torch.clamp(z_prior, cfg.depth_min, cfg.depth_max)
    nlv = min(3, cfg.pyramid_levels)
    stereo_params = dataclasses.replace(_lk_params(cfg), num_levels=nlv)
    disp, ok = lk_ops.stereo_lk(pyr0[:nlv], pyr1[:nlv], table.uv, disp_guess,
                                table.active, stereo_params)
    z = cam.fx * cam.baseline / torch.clamp(disp, min=1e-3)
    ok = ok & (z > cfg.depth_min) & (z < cfg.depth_max)
    stereo_ok = ok

    T0 = table.obs0_pose()
    C0 = -so3.rotate(so3.conj(T0.q), T0.t)
    C1 = -so3.rotate(so3.conj(T_c_w.q), T_c_w.t)
    base = torch.linalg.vector_norm(C1[None, :] - C0, dim=-1)
    xn0 = cam_m.unit_ray(cam, table.obs0_uv)[:, :2]
    xn1 = cam_m.unit_ray(cam, table.uv)[:, :2]
    pts_c1, tri_valid = triangulation.triangulate_midpoint(
        SE3(T_c_w.q.expand_as(T0.q), T_c_w.t.expand_as(T0.t)), T0, xn1, xn0,
        range_max=cfg.depth_max, range_min=cfg.depth_min)
    tri_ok = tri_valid & table.active & (base >= cfg.tri_min_baseline) & ~ok
    z = torch.where(tri_ok, pts_c1[:, 2], z)
    return z, ok | tri_ok, stereo_ok


def _depth_innovation(cfg: FrontendConfig, cam: StereoCamera, table: lt.LandmarkTable,
                      T_c_w: SE3, z_meas, meas_ok, stereo_ok, z_dummy,
                      bootstrap: bool = False):
    """IIR depth fusion with two-consistent-measurement adoption and eviction
    of persistently inconsistent depths (CameraFrame::depthInnovation)."""
    z_old = se3m.transform_points(T_c_w, table.p_w)[:, 2]
    rel_jump = torch.abs(z_meas - z_old) / torch.clamp(z_old, min=1e-3)
    accept = meas_ok & (rel_jump < cfg.innovation_gate)
    z_fused = torch.where(
        table.has_3d,
        torch.where(accept, (1.0 - cfg.iir_ratio) * z_old + cfg.iir_ratio * z_meas, z_old),
        z_meas)

    pend_rel = torch.abs(z_meas - table.z_pend) / torch.clamp(table.z_pend, min=1e-3)
    pend_agree = table.pend_ok & (pend_rel < cfg.innovation_gate)
    if bootstrap:
        adopt = ~table.has_3d & meas_ok
    else:
        adopt = ~table.has_3d & meas_ok & pend_agree
    z_fused = torch.where(adopt, torch.where(pend_agree, 0.5 * (z_meas + table.z_pend),
                                             z_meas), z_fused)
    z_pend = torch.where(~table.has_3d & meas_ok & ~adopt, z_meas, table.z_pend)
    pend_ok = ~table.has_3d & ~adopt & (table.pend_ok | meas_ok)

    rej = torch.where(table.has_3d & meas_ok & ~accept, table.rej_count + 1,
                      torch.where(table.has_3d & accept, 0, table.rej_count))
    evict = table.has_3d & (rej >= 3)

    if cfg.dummy_depth:
        unmeasured = ~table.has_3d & ~meas_ok
        z_fused = torch.where(unmeasured, z_dummy, z_fused)
        adopt = adopt | unmeasured
        new_has = table.active & ~evict
    else:
        new_has = table.active & (table.has_3d | adopt) & ~evict

    p_w_new = cam_m.cam_to_world(T_c_w, cam_m.backproject(cam, table.uv, z_fused))
    rewrite = (accept | adopt) & new_has
    p_w = torch.where(rewrite[:, None], p_w_new, table.p_w)
    ur = table.uv[:, 0] - cam.fx * cam.baseline / torch.clamp(z_meas, min=1e-3)
    ur_ok = stereo_ok & table.active & (cam.baseline > 0)
    return dataclasses.replace(
        table, p_w=p_w, has_3d=new_has,
        ur=torch.where(ur_ok, ur, table.ur), ur_ok=ur_ok,
        z_pend=z_pend, pend_ok=pend_ok,
        rej_count=torch.where(evict, 0, rej).to(torch.int32))


def _redetect(cfg: FrontendConfig, img0, table: lt.LandmarkTable, T_c_w: SE3, next_id):
    cand_uv, _, cand_valid = feat_ops.detect_grid_features(
        img0, table.uv, table.active, _detect_params(cfg))
    return lt.fill_new_detections(table, cand_uv, cand_valid, T_c_w, next_id)


def _init_branch(cfg, cam, state: TrackerState, pyr0, pyr1, d_img, T_init: SE3,
                 draws: Draws):
    """UnInit / TrackingFail recovery: wipe, detect, bootstrap depth."""
    dev = state.status.device
    table = lt.empty(cfg.num_slots, device=dev, dtype=state.table.uv.dtype)
    table, next_id = _redetect(cfg, pyr0[0][0], table, T_init, state.next_lm_id)
    z, ok, st_ok = _measure_depth(cfg, cam, pyr0, pyr1, d_img, table, T_init)
    table = _depth_innovation(cfg, cam, table, T_init, z, ok, st_ok, draws.depth,
                              bootstrap=True)
    was_fail = state.status == STATUS_FAIL
    new_state = dataclasses.replace(
        state, table=table, T_c_w=T_init, T_prev=T_init,
        velocity=torch.zeros_like(state.velocity),
        status=_i32(STATUS_TRACKING, dev),
        next_lm_id=next_id, last_kf_T=T_init,
        kf_count=state.kf_count + 1,
        frames_since_kf=_i32(0, dev),
        fail_count=_i32(0, dev),
        recover_count=torch.where(was_fail, state.recover_count + 1, 0).to(torch.int32))
    out = FrameOutput(
        T_c_w=T_init,
        is_keyframe=torch.ones((), dtype=torch.bool, device=dev),
        reset_backend=was_fail & (state.recover_count % 2 == 0),
        num_inliers=lt.num_tracked_3d(table),
        mean_reproj_err=torch.zeros((), dtype=torch.float32, device=dev),
        status=new_state.status)
    return new_state, out


def _track_branch(cfg, cam, state: TrackerState, pyr_prev, pyr0, pyr1, d_img,
                  T_prior: SE3, draws: Draws):
    table = state.table
    dev = state.status.device

    # STEP2: LK with the projected initial guess.
    p_c_pred = se3m.transform_points(T_prior, table.p_w)
    uv_guess_3d = cam_m.project(cam, p_c_pred)
    use_proj = table.has_3d & (p_c_pred[:, 2] > cfg.depth_min) \
        & cam_m.in_bounds(cam, uv_guess_3d)
    uv_guess = torch.where(use_proj[:, None], uv_guess_3d, table.uv)
    uv_new, lk_ok = lk_ops.pyramidal_lk(pyr_prev, pyr0, table.uv, uv_guess,
                                        table.active, _lk_params(cfg))

    # STEP2b: fundamental-matrix consistency gate.
    f_inl, _, _ = ransac_ops.fundamental_ransac(
        draws.ransac, table.uv, uv_new, table.active & lk_ok,
        threshold=cfg.ransac_threshold)

    # STEP3: motion-only BA from two starts (the prior, and the prior plus a
    # pure translation explaining the median flow); lower residual wins.
    ba_mask = table.active & lk_ok & f_inl & table.has_3d
    flow = uv_new - table.uv
    z_med = torch.nan_to_num(_nanmedian(torch.where(ba_mask, p_c_pred[:, 2], torch.nan)),
                             nan=4.0)
    fl_med = torch.nan_to_num(_nanmedian(torch.where(ba_mask[:, None], flow, torch.nan),
                                         dim=0))
    zero = torch.zeros_like(z_med)
    t_hyp = torch.stack([-fl_med[0] * z_med / cam.fx, -fl_med[1] * z_med / cam.fy, zero])
    T_prior_b = se3m.compose(SE3(so3.identity(device=dev), t_hyp), T_prior)

    def run_ba(T0):
        return motion_ba.optimize_pose(
            cam, T0, table.p_w, uv_new, ba_mask, iters1=cfg.ba_iters1,
            iters2=cfg.ba_iters2, huber_delta=cfg.huber_delta,
            chi2_cull=cfg.chi2_cull, min_points=cfg.min_inliers)

    def mean_err(T):
        rn = torch.linalg.vector_norm(cam_m.project_world(cam, T, table.p_w) - uv_new, dim=-1)
        return torch.sum(torch.where(ba_mask, torch.clamp(rn, max=5.0), 0.0)) / \
            torch.clamp(torch.sum(ba_mask), min=1)

    ba_a, ba_b = run_ba(T_prior), run_ba(T_prior_b)
    ba = tree_where(mean_err(ba_b.T_c_w) < mean_err(ba_a.T_c_w), ba_b, ba_a)
    T_new = ba.T_c_w

    # STEP4: median+MAD reprojection gate.
    def eval_pose(T, ba_inl):
        err = torch.linalg.vector_norm(cam_m.project_world(cam, T, table.p_w) - uv_new,
                                       dim=-1)
        mad_ok, _ = ransac_ops.mad_gate(err, ba_mask & ba_inl, sigma_mult=cfg.mad_sigma)
        survivors = table.active & lk_ok & f_inl & torch.where(table.has_3d, mad_ok, True)
        return survivors, torch.sum(survivors & table.has_3d), err

    survivors, num_inl, err = eval_pose(T_new, ba.inliers)

    # Prior-free PnP rescue on starvation (host branch; see module doc).
    if cfg.pnp_fallback and bool(num_inl < cfg.min_inliers):
        xn = torch.stack([(uv_new[:, 0] - cam.cx) / cam.fx,
                          (uv_new[:, 1] - cam.cy) / cam.fy], dim=-1)
        T_pnp, _, _ = pnp_ops.pnp_ransac(draws.pnp, table.p_w, xn, ba_mask,
                                         threshold_n=cfg.ransac_threshold / cam.fx)
        ba2 = run_ba(T_pnp)
        T_new = ba2.T_c_w
        survivors, num_inl, err = eval_pose(T_new, ba2.inliers)

    failed = num_inl < cfg.min_inliers

    table = dataclasses.replace(
        table, uv=torch.where(lk_ok[:, None], uv_new, table.uv), inlier=survivors,
        age=torch.where(survivors, table.age + 1, table.age))
    table = lt.kill(table, table.active & ~survivors)
    mean_err_out = torch.sum(torch.where(survivors & table.has_3d, err, 0.0)) / \
        torch.clamp(num_inl, min=1)

    # STEP5: redetect into freed slots.
    table, next_id = _redetect(cfg, pyr0[0][0], table, T_new, state.next_lm_id)
    # STEP6: depth innovation.
    z, z_ok, st_ok = _measure_depth(cfg, cam, pyr0, pyr1, d_img, table, T_new)
    table = _depth_innovation(cfg, cam, table, T_new, z, z_ok, st_ok, draws.depth)

    # STEP7/8: motion model + keyframe decision.
    velocity = se3m.log(se3m.compose(T_new, se3m.inverse(state.T_prev)))
    dt_norm, dr_norm = se3m.distance(state.last_kf_T, T_new)
    bootstrap = (state.frame_id < cfg.kf_bootstrap_frames) & (
        (state.frames_since_kf + 1) >= cfg.kf_bootstrap_every)
    is_kf = (~failed) & ((dt_norm >= cfg.kf_min_trans) | (dr_norm >= cfg.kf_min_rot)
                         | bootstrap)

    # Two-strike failure entry: the first bad frame is escaped (state kept).
    second = failed & (state.fail_count + 1 >= 2)
    new_status = torch.where(second, STATUS_FAIL, STATUS_TRACKING).to(torch.int32)
    new_fail_count = torch.where(failed, torch.where(second, 0, state.fail_count + 1),
                                 0).to(torch.int32)
    zero_i = _i32(0, dev)
    new_state = dataclasses.replace(
        state, table=table, T_c_w=T_new, T_prev=T_new, velocity=velocity,
        status=new_status, next_lm_id=next_id,
        last_kf_T=se3m.where(is_kf, T_new, state.last_kf_T),
        kf_count=state.kf_count + is_kf.to(torch.int32),
        frames_since_kf=torch.where(is_kf, 0, state.frames_since_kf + 1).to(torch.int32),
        fail_count=new_fail_count, recover_count=zero_i)
    esc_state = dataclasses.replace(state, status=new_status, fail_count=new_fail_count,
                                    recover_count=zero_i)
    new_state = tree_where(failed, esc_state, new_state)
    out = FrameOutput(
        T_c_w=se3m.where(failed, state.T_c_w, T_new),
        is_keyframe=is_kf,
        reset_backend=torch.zeros((), dtype=torch.bool, device=dev),
        num_inliers=num_inl,
        mean_reproj_err=mean_err_out,
        status=new_status)
    return new_state, out


def _set_row(a, i, v):
    return a.index_copy(0, i.reshape(1).long(), v.reshape((1,) + a.shape[1:]).to(a.dtype))


def track_frame(cfg: FrontendConfig, cam: StereoCamera, state: TrackerState,
                img0, img1, prior_T: Optional[SE3] = None, use_prior: bool = False,
                draws: Optional[Draws] = None,
                generator: Optional[torch.Generator] = None):
    """Process one stereo (or RGB-D) frame; returns (new_state, FrameOutput).

    img0/img1 (H, W) on the state's device, uint8 or float32 (uint8 widens
    on the device; a depth-mode img1 keeps its dtype).  prior_T replaces
    the constant-velocity prediction when use_prior.  The frame's random
    draws come from `draws`, else from `generator`."""
    dev = state.status.device
    if draws is None:
        if generator is None:
            raise ValueError("track_frame needs `draws` or a torch.Generator")
        draws = make_draws(cfg, generator, dev)
    if img0.dtype != torch.float32:
        img0 = img0.to(torch.float32)
    if not cfg.depth_mode and img1.dtype != torch.float32:
        img1 = img1.to(torch.float32)

    if cfg.depth_mode:
        if cfg.equalize:
            img0 = imops.equalize_hist(img0)
        pyrs = imops.build_grad_pyramid(torch.stack([state.img_prev, img0]),
                                        cfg.pyramid_levels)
        pyr1, d_img = None, img1
        img_prev_next = img0
    else:
        pair = torch.stack([img0, img1])
        if cfg.equalize:
            pair = imops.equalize_hist(pair)
        pyrs = imops.build_grad_pyramid(torch.cat([state.img_prev[None], pair]),
                                        cfg.pyramid_levels)
        pyr1 = tuple((im[2], gx[2], gy[2]) for im, gx, gy in pyrs)
        d_img = None
        img_prev_next = pair[0]
    pyr_prev = tuple((im[0], gx[0], gy[0]) for im, gx, gy in pyrs)
    pyr0 = tuple((im[1], gx[1], gy[1]) for im, gx, gy in pyrs)

    if use_prior and prior_T is not None:
        T_pred = prior_T
    else:
        T_pred = se3m.compose(se3m.exp(state.velocity), state.T_prev)

    # Host branch on the tracking status (see module doc).
    if bool(state.status == STATUS_TRACKING):
        new_state, out = _track_branch(cfg, cam, state, pyr_prev, pyr0, pyr1, d_img,
                                       T_pred, draws)
    else:
        new_state, out = _init_branch(cfg, cam, state, pyr0, pyr1, d_img, T_pred, draws)

    # Escaped frames keep the last good LK template.
    escaped = (new_state.fail_count > state.fail_count) | (new_state.status == STATUS_FAIL)
    h = new_state.ring_head
    new_state = dataclasses.replace(
        new_state,
        img_prev=torch.where(escaped, state.img_prev, img_prev_next),
        frame_id=state.frame_id + 1,
        ring_q=_set_row(new_state.ring_q, h, new_state.T_c_w.q),
        ring_t=_set_row(new_state.ring_t, h, new_state.T_c_w.t),
        ring_fid=_set_row(new_state.ring_fid, h, state.frame_id),
        ring_head=((h + 1) % new_state.ring_fid.shape[0]).to(torch.int32))
    return new_state, out


def make_keyframe_packet(state: TrackerState, out: FrameOutput) -> KeyframePacket:
    """Snapshot the landmark table for the backend (frame_id is the frame
    just processed)."""
    t = state.table
    mask = t.active & t.has_3d & t.inlier
    return KeyframePacket(
        frame_id=state.frame_id - 1, q=state.T_c_w.q, t=state.T_c_w.t,
        lm_id=t.lm_id, lm_uv=t.uv, lm_ur=t.ur, lm_ur_mask=t.ur_ok & mask,
        lm_pw=t.p_w, lm_mask=mask)


def _ring_rebase(state: TrackerState, frame_id, T_new: SE3, do):
    """Rebase delta from the ring entry of frame_id onto T_new, and the
    `found` gate (the entry exists and `do`)."""
    hit = state.ring_fid == frame_id
    found = torch.any(hit) & do
    idx = torch.argmax(hit.to(torch.int32)).reshape(1)
    T_old = SE3(state.ring_q.index_select(0, idx)[0], state.ring_t.index_select(0, idx)[0])
    return se3m.compose(se3m.inverse(T_old), T_new), found


def _rebase_chain(state: TrackerState, frame_id, delta: SE3, found) -> dict:
    def rebase(T):
        return se3m.where(found, se3m.compose(T, delta), T)

    newer = (state.ring_fid >= frame_id) & (state.ring_fid >= 0) & found
    ring_T = se3m.compose(SE3(state.ring_q, state.ring_t), delta)
    return dict(T_c_w=rebase(state.T_c_w), T_prev=rebase(state.T_prev),
                last_kf_T=rebase(state.last_kf_T),
                ring_q=torch.where(newer[:, None], ring_T.q, state.ring_q),
                ring_t=torch.where(newer[:, None], ring_T.t, state.ring_t))


def apply_correction(state: TrackerState, corr) -> TrackerState:
    """Apply a (late) backend Correction: rebase the pose chain onto the
    corrected keyframe pose, overwrite matched landmark positions, kill
    outliers.  Every effect is gated on corr.valid on the device, so the
    reference's lax.cond on corr.valid needs no branch here."""
    delta, found = _ring_rebase(state, corr.frame_id, SE3(corr.q, corr.t), corr.valid)
    t = state.table
    eq = (t.lm_id[:, None] == corr.lm_id[None, :]) & corr.lm_mask[None, :] \
        & (t.lm_id[:, None] >= 0)
    has = torch.any(eq, dim=1) & found
    src = torch.argmax(eq.to(torch.int32), dim=1)
    p_w = torch.where(has[:, None], corr.lm_pw[src], t.p_w)
    out_eq = (t.lm_id[:, None] == corr.outlier_id[None, :]) & corr.outlier_mask[None, :] \
        & (t.lm_id[:, None] >= 0)
    is_out = torch.any(out_eq, dim=1) & found
    table = dataclasses.replace(t, p_w=p_w, active=t.active & ~is_out,
                                inlier=t.inlier & ~is_out)
    return dataclasses.replace(state, table=table,
                               **_rebase_chain(state, corr.frame_id, delta, found))


def rebase_pose(state: TrackerState, frame_id, T_new: SE3, do) -> TrackerState:
    """Pose-only rebase of the chain and the ring entries at/after frame_id
    onto T_new (landmarks untouched)."""
    delta, found = _ring_rebase(state, frame_id, T_new, do)
    return dataclasses.replace(state, **_rebase_chain(state, frame_id, delta, found))


def track_frames_scan(cfg: FrontendConfig, cam: StereoCamera, state: TrackerState,
                      imgs0, imgs1, generator: torch.Generator,
                      with_packets: bool = False):
    """Track T stacked frames in order (the reference's lax.scan is a Python
    loop here).  Returns (final state, FrameOutput stacked over T[, packets
    stacked over T])."""
    outs, pkts = [], []
    for i0, i1 in zip(imgs0, imgs1):
        state, out = track_frame(cfg, cam, state, i0, i1, generator=generator)
        outs.append(out)
        if with_packets:
            pkts.append(make_keyframe_packet(state, out))
    stacked = tree_map(lambda *xs: torch.stack(xs), *outs)
    if with_packets:
        return state, stacked, tree_map(lambda *xs: torch.stack(xs), *pkts)
    return state, stacked
