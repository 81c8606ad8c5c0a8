"""Grid-bucketed Shi-Tomasi corner detection (port of flvis_tpu/ops/features.py).

Top-k order: lax.top_k puts the lowest index first among equal values (and
the -inf plateaus of suppressed pixels are ties), while torch.topk promises
no tie order on CUDA — so the per-cell top-k is a STABLE descending sort
truncated to k.  The NMS window max is max_pool2d with implicit -inf
padding, which equals the reference's doubling-shift max with -inf fill.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import image as imops


@dataclasses.dataclass(frozen=True)
class DetectParams:
    grid_rows: int = 4
    grid_cols: int = 4
    per_cell: int = 16
    min_distance: float = 15.0
    quality_level: float = 0.01
    margin: int = 20
    block_radius: int = 1


def shi_tomasi_response(img, block_radius: int = 1):
    """Min-eigenvalue corner response map (cv::cornerMinEigenVal)."""
    ix, iy = imops.sobel_gradients(img)
    a = imops.box_filter(ix * ix, block_radius)
    b = imops.box_filter(ix * iy, block_radius)
    c = imops.box_filter(iy * iy, block_radius)
    half_tr = 0.5 * (a + c)
    return half_tr - torch.sqrt(torch.clamp((0.5 * (a - c)) ** 2 + b * b, min=0.0))


def _nms(resp, radius: int):
    """Keep pixels that equal the max of their (2r+1)² neighbourhood
    (plateaus are kept, as in the reference)."""
    k = 2 * radius + 1
    pooled = F.max_pool2d(resp[None, None], kernel_size=k, stride=1, padding=radius)[0, 0]
    return torch.where(resp >= pooled, resp, -torch.inf)


def stable_topk(x, k: int):
    """(values, indices) of the k largest along the last dim, lowest index
    first among ties (lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_grid_features(img, existing_uv, existing_mask,
                         params: DetectParams = DetectParams()):
    """Up to rows·cols·per_cell new corners: (uv (K, 2), score (K,),
    valid (K,)), ordered cell-major then score-descending."""
    h, w = img.shape
    rows, cols, k = params.grid_rows, params.grid_cols, params.per_cell
    dev = img.device

    resp = shi_tomasi_response(img, params.block_radius)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    m = params.margin
    border_ok = (yy >= m) & (yy < h - m) & (xx >= m) & (xx < w - m)
    thresh = params.quality_level * torch.max(resp)
    resp = torch.where(border_ok & (resp > thresh), resp, -torch.inf)
    resp = _nms(resp, max(int(params.min_distance // 2), 1))

    ch = -(-h // rows)
    cw = -(-w // cols)
    padded = torch.full((ch * rows, cw * cols), -torch.inf, dtype=resp.dtype, device=dev)
    padded[:h, :w] = resp
    cells = padded.reshape(rows, ch, cols, cw).permute(0, 2, 1, 3).reshape(rows * cols, ch * cw)
    top_val, top_idx = stable_topk(cells, k)
    cy = top_idx // cw
    cx = top_idx % cw
    cell = torch.arange(rows * cols, device=dev)
    px = ((cell % cols)[:, None] * cw + cx).to(img.dtype)
    py = ((cell // cols)[:, None] * ch + cy).to(img.dtype)
    uv = torch.stack([px, py], dim=-1).reshape(-1, 2)
    score = top_val.reshape(-1)
    valid = torch.isfinite(score)

    d2 = torch.sum((uv[:, None, :] - existing_uv[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(existing_mask[None, :], d2, torch.inf)
    if d2.shape[1] > 0:
        clear = torch.min(d2, dim=-1).values > params.min_distance ** 2
        valid = valid & clear
    return uv, torch.where(valid, score, 0.0), valid
