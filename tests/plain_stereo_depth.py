"""The plain reference of a keypoint's stereo depth on a rectified pair:
exhaustive integer block matching, in plain PyTorch, float32, TF32 off.

For each keypoint (u, v) of the left image the 9×9 block around it is
compared, by the sum of absolute differences (SAD), with the right image's
block around (u − d, v) for every integer disparity d in 0 … d_max (160 by
default, full resolution); the least cost's d is refined by a parabola
through it and its two neighbours (the offset clamped to ±0.5 px).  Blocks
are sampled bilinearly at the keypoint's own sub-pixel position.  Depth is
fx·b / disparity.

A keypoint is valid where its left block lies inside the image, its block
is textured (SAD from the block's mean above 4 a pixel), the best d is
neither 0 nor d_max, the right block at the best d lies inside the image,
the match explains the block (its SAD at most half the block's SAD from
its mean: a point whose true match lies outside the right image, near the
left border, matches worse than that), and the match is unambiguous (the
least cost more than 2 disparities away exceeds 1.05 × the best + 1e-3).

Departures from the program's own path (frontend/tracker.py's init frame:
ops/stereo.disparity_sweep sampled at the keypoints, then the stereo LK):
this works at full resolution where the sweep works at half, over 161
disparities where the sweep covers 64 at half resolution (128 px), and
with a plain SAD of bilinear samples where the sweep box-sums SAD on the
half-resolution pixel grid and the LK refines by image gradients.  So the
two agree to a fraction of a pixel on smooth texture, not bit for bit.

This file imports nothing of flvis_tpu_torch or of the JAX package.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RADIUS = 4                      # 9×9 blocks
D_MAX = 160                     # full-resolution pixels
TEXTURE = 4.0                   # mean absolute deviation of a textured block, per pixel
UNIQUE = 1.05
MATCH = 0.5                     # the best SAD over the block's SAD from its mean


def _bilinear(img, x, y):
    """img (H, W) at float positions x, y (same shape), clamped to the
    image."""
    h, w = img.shape
    x = torch.clamp(x, 0.0, w - 1.000001)
    y = torch.clamp(y, 0.0, h - 1.000001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def keypoint_depth(img_l, img_r, uv, fx_b: float, d_max: int = D_MAX):
    """(disparity (N,), depth (N,), valid (N,) bool) of the keypoints uv
    (N, 2) [u, v] on the rectified pair img_l, img_r (H, W); fx_b is
    fx · baseline (px · m).  float32 throughout."""
    L = torch.as_tensor(img_l, dtype=torch.float32)
    R = torch.as_tensor(img_r, dtype=torch.float32).to(L.device)
    uv = torch.as_tensor(uv, dtype=torch.float32).to(L.device)
    h, w = L.shape
    off = torch.arange(-RADIUS, RADIUS + 1, dtype=torch.float32, device=L.device)
    dy, dx = torch.meshgrid(off, off, indexing="ij")
    xs = uv[:, 0, None, None] + dx                        # (N, 9, 9)
    ys = uv[:, 1, None, None] + dy
    left = _bilinear(L, xs, ys)
    ds = torch.arange(d_max + 1, dtype=torch.float32, device=L.device)
    right = _bilinear(R, xs[None] - ds[:, None, None, None], ys[None].expand(len(ds), -1, -1, -1))
    cost = torch.abs(right - left[None]).sum(dim=(2, 3))  # (D + 1, N)
    # A right block that leaves the image is no candidate.
    inside_r = (uv[None, :, 0] - RADIUS - ds[:, None]) >= 0
    cost = torch.where(inside_r, cost, torch.full_like(cost, float("inf")))
    c_best, best = torch.min(cost, dim=0)                 # first minimum among ties
    n = torch.arange(len(uv), device=L.device)
    cm = cost[torch.clamp(best - 1, min=0), n]
    cp = cost[torch.clamp(best + 1, max=d_max), n]
    denom = cm + cp - 2.0 * c_best
    ok_fit = torch.isfinite(denom) & (denom > 1e-3)
    delta = torch.where(ok_fit, 0.5 * (cm - cp) / torch.where(ok_fit, denom, 1.0),
                        torch.zeros_like(denom))
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)
    far = torch.abs(best[None] - torch.arange(d_max + 1, device=L.device)[:, None]) > 2
    c2 = torch.min(torch.where(far, cost, torch.full_like(cost, float("inf"))), dim=0).values
    texture = torch.abs(left - left.mean(dim=(1, 2), keepdim=True)).sum(dim=(1, 2))
    inside_l = ((uv[:, 0] - RADIUS >= 0) & (uv[:, 0] + RADIUS <= w - 1)
                & (uv[:, 1] - RADIUS >= 0) & (uv[:, 1] + RADIUS <= h - 1))
    valid = (inside_l & torch.isfinite(c_best) & (best > 0) & (best < d_max)
             & (texture > TEXTURE * (2 * RADIUS + 1) ** 2) & (c_best <= MATCH * texture)
             & (c2 > UNIQUE * c_best + 1e-3))
    depth = fx_b / torch.clamp(disp, min=1e-3)
    return disp, depth, valid
