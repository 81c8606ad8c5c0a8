"""fast_score_nms_blur: the FAST-9 corner score with 3×3 keep-ties non-max
suppression and the detection-margin mask, plus the 7-tap σ=2 Gaussian
blur, of one (H, W) float32 image.

Replaces the TPU kernel flvis_tpu/ops/pallas/fastblur.py:
fast_score_nms_blur_pallas (called from ops/orb.detect_and_compute on every
loop-node keyframe).

Semantics follow the TPU kernel: the image is seen through an edge-replicate
border (ops/orb.fast_score roll-wraps instead; the two agree inside a margin
of at least 4 px, fastblur.py:30-35), the raw score is computed on the
1-px-extended region so NMS at the tile edge sees its neighbours, and the
blur matches ops/image.gaussian_blur(sigma=2, ksize=7) with edge padding.

On the H100 (csrc/fastblur.cu) the byte bound is 12 B/pixel (one image
in, two maps out; 4.3 MB, ~1.3 µs at 3.35 TB/s, at 752×480), but the FAST
ring test costs over a hundred instructions for each scored point, so the
instruction stream is the floor the design works on.  A block of 128
threads owns 126 output columns by 11 rows; each thread owns one image
column and walks the staged rows once, keeping the last 7 in registers,
which feed both its ring tests and its blur.  The ring test forms the
bright/dark masks from the sign bits of thr − |d| and d (one funnel shift
each, exact against the plain version's compares) and tests arc 9 with a
doubling chain on the duplicated mask.  Staging reads 16 bytes a
lane at clamped coordinates (the edge border, so no padded copy exists);
264 blocks at 480×752 are two on each of 132 SMs.  Scores of [0, 255] images
are sums of |differences| − threshold, so kernel and plain version agree to
float rounding of the sum order (held at 1e-3, with the same corner set).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import image as imops
from . import _build

# 16-pixel Bresenham circle of radius 3, OpenCV order (flvis_tpu/ops/orb.py:34).
CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
])
SIGMA = 2.0


def fast_score_nms_blur_plain(img, threshold: float = 20.0, margin: int = 20):
    """Plain PyTorch version, the TPU kernel's arithmetic on the whole image."""
    H, W = img.shape
    p = imops.edge_pad(img, 4)                        # (H+8, W+8)
    he, we = H + 2, W + 2                             # 1-px-extended region
    center = p[3:3 + he, 3:3 + we]
    diffs = torch.stack([p[3 + dy:3 + dy + he, 3 + dx:3 + dx + we] - center
                         for dx, dy in CIRCLE.tolist()])      # (16, he, we)
    ad = torch.abs(diffs)
    score = torch.sum(torch.where(ad > threshold, ad - threshold, 0.0), dim=0)

    def arc9(mask):
        acc = mask
        for k in range(1, 9):
            acc = acc & torch.roll(mask, -k, dims=0)
        return torch.any(acc, dim=0)

    score = torch.where(arc9(diffs > threshold) | arc9(diffs < -threshold), score, 0.0)
    pooled = score[0:H, 0:W]
    for dy in range(3):
        for dx in range(3):
            pooled = torch.maximum(pooled, score[dy:dy + H, dx:dx + W])
    cen = score[1:1 + H, 1:1 + W]
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    ok = (yy >= margin) & (yy < H - margin) & (xx >= margin) & (xx < W - margin)
    return (torch.where((cen >= pooled) & ok, cen, 0.0),
            imops.gaussian_blur(img, sigma=SIGMA, ksize=7))


def fast_score_nms_blur_kernel(img, threshold: float = 20.0, margin: int = 20):
    """Launch csrc/fastblur.cu on a contiguous (H, W) float32 CUDA image."""
    _build.require_cuda_f32("fast_score_nms_blur", img=img)
    if img.dim() != 2:
        raise ValueError(f"fast_score_nms_blur: expected (H, W), got {tuple(img.shape)}")
    if margin < 4:
        raise ValueError("fast_score_nms_blur: margin must be >= 4 (the border band "
                         "where edge padding and wrap-around differ)")
    H, W = img.shape
    score = torch.empty_like(img)
    blur = torch.empty_like(img)
    lib, _ = _build.load_library()
    with torch.cuda.device(img.device):
        err = lib.flvis_fast_score_nms_blur(img.data_ptr(), score.data_ptr(),
                                            blur.data_ptr(), H, W, float(threshold),
                                            int(margin), SIGMA, _build.stream_of(img))
    _build.check_launch("fast_score_nms_blur", err)
    fast_score_nms_blur_kernel.launches += 1
    return score, blur


fast_score_nms_blur_kernel.launches = 0


def fast_score_nms_blur(img, threshold: float = 20.0, margin: int = 20):
    """(H, W) → (suppressed FAST-9 score, σ=2 blur).  CPU tensors take the
    plain version; CUDA tensors launch the kernel (which raises on what it
    cannot take)."""
    if img.is_cuda:
        return fast_score_nms_blur_kernel(img, threshold, margin)
    if img.device.type == "cpu":
        return fast_score_nms_blur_plain(img, threshold, margin)
    raise ValueError(f"fast_score_nms_blur: unsupported device {img.device}")
