"""Batched pyramidal Lucas-Kanade optical flow (port of flvis_tpu/ops/lk.py).

All points advance together: per level, the template patch and its
gradients are gathered once, the search window of the next image is
gathered once, and a fixed budget of Gauss-Newton iterations with a 2×2
closed-form solve samples the current patch INSIDE that window.

Ported in direct form: where the reference samples the window with
hat-function selection matmuls (lk.py:39-57,104-111, a TPU-MXU idiom), this
port gathers the two bracketing rows and columns and blends them
bilinearly — the same weights, (1-f, f) at floor(rel)+i and +i+1.

Early exit: the reference's while_loop stops once fewer than 2 % of live
points are unconverged (lk.py:135-162).  Here the loop runs its static trip
count and a device-side sticky `go` flag is ANDed into every update: once
`go` drops, flow and the converged mask stop changing — exactly the state
the reference's while_loop exits with — and no host sync is needed.
"""

from __future__ import annotations

import dataclasses

import torch

from . import image as imops


@dataclasses.dataclass(frozen=True)
class LKParams:
    radius: int = 10          # half window; side = 2r+1
    num_levels: int = 4
    iters: int = 10           # GN iterations per level
    min_eig: float = 1e-4     # min eigenvalue of H per pixel
    eps: float = 0.01         # convergence threshold on |delta|
    search_margin: int = 8    # px the flow may drift within one level's window


def _sample_window(win, rel, s: int):
    """Bilinear (N, s, s) patch inside win (N, wd, wd); rel (N, 2) [x, y] is
    the position of patch element (0, 0) relative to the window corner."""
    wd = win.shape[-1]
    rel = torch.clamp(rel, 0.0, wd - s - 1 - 1e-4)
    base = torch.floor(rel)
    f = rel - base
    i0 = base.long()
    ar = torch.arange(s, device=win.device)
    iy = (i0[:, 1:2] + ar)[:, :, None]                       # (N, s, 1)
    fy = f[:, 1, None, None]
    rows = (torch.take_along_dim(win, iy, dim=1) * (1 - fy)
            + torch.take_along_dim(win, iy + 1, dim=1) * fy)   # (N, s, wd)
    ix = (i0[:, 0:1] + ar)[:, None, :]                       # (N, 1, s)
    fx = f[:, 0, None, None]
    return (torch.take_along_dim(rows, ix, dim=2) * (1 - fx)
            + torch.take_along_dim(rows, ix + 1, dim=2) * fx)


def _track_level(img_prev, grad_x, grad_y, img_next, pts_prev, flow, valid,
                 p: LKParams):
    """One pyramid level of LK; returns (flow, wellcond)."""
    r = p.radius
    m = p.search_margin
    s = 2 * r + 1
    wd = s + 2 * m + 2
    n = pts_prev.shape[0]

    # The three planes are read in place (gx, gy are views of grad_blur's
    # outputs): no stacked copy.
    tgg = imops.extract_patches_multi((img_prev, grad_x, grad_y), pts_prev, r)
    gx, gy = tgg[:, 1], tgg[:, 2]
    G = torch.stack([gx.reshape(n, -1), gy.reshape(n, -1)], dim=-1)   # (N, S², 2)
    A = torch.einsum("nsk,nsl->nkl", G, G)
    a11, a12, a22 = A[:, 0, 0], A[:, 0, 1], A[:, 1, 1]
    det = a11 * a22 - a12 * a12
    tr = a11 + a22
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) * 0.5
    wellcond = min_eig / (s * s) > p.min_eig
    update_ok = valid & wellcond
    det_safe = torch.where(torch.abs(det) < 1e-12, 1.0, det)
    t_flat = tgg[:, 0].reshape(n, -1)

    corner = torch.floor(pts_prev + flow) - (r + m)
    win, corner = imops.extract_windows(img_next, corner, wd)
    corner = corner.to(flow.dtype)
    pos_lo = corner + r
    pos_hi = corner + wd - r - 2

    def clamp_flow(fl):
        return torch.minimum(torch.maximum(pts_prev + fl, pos_lo), pos_hi) - pts_prev

    flow = clamp_flow(flow)
    converged = torch.zeros(n, dtype=torch.bool, device=flow.device)
    n_live = torch.clamp(torch.sum(update_ok), min=1)
    go = torch.ones((), dtype=torch.bool, device=flow.device)
    eps2 = p.eps * p.eps

    def gn_step(flow, converged, live):
        cur = _sample_window(win, pts_prev + flow - corner - r, s)
        e = cur.reshape(n, -1) - t_flat
        b = torch.einsum("ns,nsk->nk", e, G)
        dx = (a22 * b[:, 0] - a12 * b[:, 1]) / det_safe
        dy = (a11 * b[:, 1] - a12 * b[:, 0]) / det_safe
        delta = torch.stack([-dx, -dy], dim=-1)
        step_ok = update_ok & ~converged & live
        flow = torch.where(step_ok[:, None], clamp_flow(flow + delta), flow)
        conv_new = converged | (torch.sum(delta * delta, dim=-1) < eps2)
        return flow, torch.where(live, conv_new, converged)

    # The reference's loop body runs two GN steps per trip (the second only
    # while i + 1 < iters) and tests its cond before every trip.
    for i in range(0, p.iters, 2):
        go = go & (torch.sum(~converged & update_ok) * 50 > n_live)
        flow, converged = gn_step(flow, converged, go)
        if i + 1 < p.iters:
            flow, converged = gn_step(flow, converged, go)
    return flow, wellcond


def pyramidal_lk(pyrg_prev, pyr_next, pts_prev, pts_guess, valid,
                 params: LKParams = LKParams()):
    """Track points from gradient pyramid pyrg_prev ((img, gx, gy) per level)
    to pyr_next (gradient pyramid or plain images).

    Returns (pts_next (N, 2), status (N,) bool).  The reference's optional
    `want_err` residual has no production caller and is not ported."""
    num_levels = len(pyrg_prev)
    if len(pyr_next) != num_levels:
        raise ValueError("pyramids differ in depth")

    def level_img(entry):
        return entry[0] if isinstance(entry, tuple) else entry

    flow = (pts_guess - pts_prev) / 2.0 ** (num_levels - 1)
    status = valid
    for lvl in range(num_levels - 1, -1, -1):
        s = 2.0 ** lvl
        img_p, gx, gy = pyrg_prev[lvl]
        flow, wellcond = _track_level(img_p, gx, gy, level_img(pyr_next[lvl]),
                                      pts_prev / s, flow, status, params)
        status = status & wellcond
        if lvl > 0:
            flow = flow * 2.0

    pts_next = pts_prev + flow
    h, w = level_img(pyr_next[0]).shape
    r = params.radius
    inb = ((pts_next[:, 0] >= r) & (pts_next[:, 0] <= w - 1 - r)
           & (pts_next[:, 1] >= r) & (pts_next[:, 1] <= h - 1 - r))
    return pts_next, status & inb


def stereo_lk(pyrg_left, pyrg_right, pts_left, disparity_guess, valid,
              params: LKParams = LKParams(), fb_threshold: float = 0.7):
    """Left→right rectified-stereo track with the vertical and
    forward-backward gates; returns (disparity, status)."""
    guess = pts_left - torch.stack([disparity_guess, torch.zeros_like(disparity_guess)], -1)
    pts_right, status = pyramidal_lk(pyrg_left, pyrg_right, pts_left, guess, valid, params)
    dy = torch.abs(pts_right[:, 1] - pts_left[:, 1])
    disparity = pts_left[:, 0] - pts_right[:, 0]
    status = status & (dy < 1.5) & (disparity > 0.0)
    fb_params = dataclasses.replace(params, num_levels=1, iters=max(params.iters // 2, 4))
    back, st_b = pyramidal_lk(pyrg_right[:1], pyrg_left[:1], pts_right, pts_left,
                              status, fb_params)
    fb_err = torch.linalg.vector_norm(back - pts_left, dim=-1)
    return disparity, status & st_b & (fb_err < fb_threshold)
