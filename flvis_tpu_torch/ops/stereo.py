"""Dense plane-sweep block-matching stereo for the loop node's keypoint
depth (port of flvis_tpu/ops/stereo.py).

The reference has two semantics for the sweep: its XLA path keeps a bf16
cost volume and edge-replicates the box support at the left/right border,
its TPU kernel works in float32 and marks a 4-column band invalid.  The
port follows the kernel (ops/kernels/sweep: the CUDA kernel on the card,
its plain twin on the CPU); the parity test holds it against the
reference's `disparity_sweep(use_kernel=True)`.
"""

from __future__ import annotations

import torch

from . import image as imops
from .kernels.sweep import box9, sweep_maps


def _box9x9(img):
    """9×9 box sum with edge padding, in the factored 9-tap form of the
    reference (stereo.py:35)."""
    p = imops.edge_pad(img, 4)
    return box9(box9(p, 1), 0)


def disparity_sweep(img_l, img_r, d_max: int = 64, radius: int = 4):
    """Half-resolution plane-sweep disparity of a rectified pair.  Returns
    (disp, valid), each (H/2, W/2): disparity in FULL-resolution pixels and
    the textured, unambiguous, in-range mask."""
    if radius != 4:
        raise ValueError("disparity_sweep: the sweep kernel is radius-4 only")

    def half(a):
        h2, w2 = a.shape[0] // 2, a.shape[1] // 2
        return a[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2).mean(dim=(1, 3))

    L, R = half(img_l), half(img_r)
    disp_h, _, ok = sweep_maps(L.contiguous(), R.contiguous(), d_max)
    area = float((2 * radius + 1) ** 2)
    texture = _box9x9(torch.abs(L - imops.box_filter(L, radius)))
    return 2.0 * disp_h, ok & (texture > 4.0 * area)


def keypoint_disparity(disp, valid, uv):
    """Sample the half-res sweep at FULL-res keypoints uv (N, 2).  Returns
    (disparity (N,), ok (N,)) in full-resolution pixels."""
    uv_h = uv * 0.5
    d = imops.bilinear_sample(disp, uv_h)
    v = imops.bilinear_sample(valid.to(torch.float32), uv_h)
    return d, v > 0.999
