"""Batched image operations: pyramids, gradients, sampling, patch gathers
(port of flvis_tpu/ops/image.py).

Images are float32 (..., H, W) in [0, 255]; sampling is clamp-to-edge.
The reference's TPU idioms are ported in their direct form, with the same
results:
  - one-hot selection-matmul block gathers (image.py:252-316) → the
    gather kernel (ops/kernels/gather.py; its plain versions, an indexed
    gather and the bilinear blend, on a CPU tensor), reading the unpadded
    image through an edge border, with the start corners clamped exactly as
    the CPU `dynamic_slice` path clamps them (image.py:274-282); the
    subpixel patches gather and blend in one launch (patches mode);
  - the one-hot matmul decimation (image.py:78-92) → a strided slice
    (pyr_down), or, in build_grad_pyramid, grad_blur's "next" mode;
  - the 16×16 factorised equalize_hist (image.py:371-409) → torch.bincount
    and a table lookup (256 bins, the only size the reference supports).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.gather import gather_patches, gather_windows

# 5-tap binomial kernel used by cv::pyrDown.
_PYR_K = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
_SCHARR_SMOOTH = np.asarray([3.0, 10.0, 3.0], np.float32) / 32.0
_DIFF = np.asarray([-1.0, 0.0, 1.0], np.float32)


def _edge_index(n: int, r: int, device):
    return torch.clamp(torch.arange(-r, n + r, device=device), 0, n - 1)


def edge_pad(img, pad: int):
    """Edge-replicate padding of the last two dims by `pad` on every side."""
    h, w = img.shape[-2:]
    p = img.index_select(-1, _edge_index(w, pad, img.device))
    return p.index_select(-2, _edge_index(h, pad, img.device))


def _sep_filter(img, kx, ky):
    """Separable filter with edge-replicate borders over the last two dims,
    as shift-and-add in the reference's tap order (x pass, then y pass)."""
    rx = int(len(kx)) // 2
    ry = int(len(ky)) // 2
    h, w = img.shape[-2:]
    p = img.index_select(-1, _edge_index(w, rx, img.device))
    acc = None
    for i, wgt in enumerate(float(v) for v in np.asarray(kx)):
        term = p[..., :, i:i + w] * wgt
        acc = term if acc is None else acc + term
    p = acc.index_select(-2, _edge_index(h, ry, img.device))
    acc = None
    for i, wgt in enumerate(float(v) for v in np.asarray(ky)):
        term = p[..., i:i + h, :] * wgt
        acc = term if acc is None else acc + term
    return acc


def pyr_down(img):
    """Gaussian blur + 2× decimation (cv::pyrDown)."""
    return _sep_filter(img, _PYR_K, _PYR_K)[..., ::2, ::2]


def build_grad_pyramid(img, num_levels: int):
    """Pyramid with per-level Scharr gradients: tuple of (img, gx, gy).

    Each level is one call of ops/kernels/gradpyr.grad_blur (the CUDA kernel
    on a CUDA tensor, the plain version on a CPU tensor): gx, gy and, in its
    "next" mode, the pyrDown low-pass at the even pixels only — the next
    level's image, decimated in the same launch; the last level takes its
    "none" mode (no blur)."""
    from .kernels.gradpyr import grad_blur

    squeeze = img.dim() == 2
    level = (img[None] if squeeze else img).contiguous()
    out = []
    for lvl in range(num_levels):
        gx, gy, nxt = grad_blur(level, "next" if lvl + 1 < num_levels else "none")
        out.append((level[0], gx[0], gy[0]) if squeeze else (level, gx, gy))
        level = nxt
    return tuple(out)


def scharr_gradients(img):
    """(Ix, Iy) via the 3×3 Scharr operator."""
    return (_sep_filter(img, _DIFF, _SCHARR_SMOOTH),
            _sep_filter(img, _SCHARR_SMOOTH, _DIFF))


def sobel_gradients(img):
    smooth = np.asarray([1.0, 2.0, 1.0], np.float32) / 4.0
    diff = np.asarray([-1.0, 0.0, 1.0], np.float32) / 2.0
    return _sep_filter(img, diff, smooth), _sep_filter(img, smooth, diff)


def box_filter(img, radius: int):
    k = np.ones(2 * radius + 1, np.float32) / (2 * radius + 1)
    return _sep_filter(img, k, k)


def gaussian_blur(img, sigma: float = 1.0, ksize: int = 5):
    r = ksize // 2
    xs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / float(sigma)) ** 2)
    return _sep_filter(img, k / np.sum(k), k / np.sum(k))


def bilinear_sample(img, xy):
    """Sample img (H, W) at subpixel xy (..., 2) [x, y], clamp-to-edge."""
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.000001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.000001)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0f
    fy = y - y0f
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _gather_blocks(img, cx, cy, size: int, pad: int):
    """Per-point (size, size) blocks of `img` edge-padded by `pad`, at
    top-left corners (cx, cy) in padded coordinates: (H, W) → (N, size,
    size); (C, H, W) → (N, C, size, size).  Corners are clamped to
    [0, dim + 2·pad − size] like jax.lax.dynamic_slice; no padded copy is
    made on the card (ops/kernels/gather.py)."""
    return gather_windows(img.contiguous(), cx, cy, size, pad)


def extract_patches(img, centers, radius: int):
    """Subpixel (N, S, S) patches (S = 2r+1) around centers (N, 2) [x, y]:
    one (S+1)² block gather per point from the edge-padded image, then a
    4-tap bilinear blend with per-point fractional weights — one launch of
    the gather kernel's patches mode on the card."""
    return gather_patches(img.contiguous(), centers, radius)


def extract_patches_int(img, centers, radius: int):
    """Integer-centred (N, S, S) patches (no bilinear blend)."""
    h, w = img.shape
    pad = radius + 1
    xi = torch.clamp(centers[:, 0].long(), -1, w) - radius + pad
    yi = torch.clamp(centers[:, 1].long(), -1, h) - radius + pad
    return _gather_blocks(img, xi, yi, 2 * radius + 1, pad)


def extract_patches_multi(stack, centers, radius: int):
    """Multi-channel extract_patches: one (C, S+1, S+1) block per point for
    all channels of stack — a (C, H, W) tensor or a sequence of C (H, W)
    planes, read in place; returns (N, C, S, S)."""
    if isinstance(stack, torch.Tensor) and stack.dim() != 3:
        raise ValueError(f"extract_patches_multi: expected (C, H, W), got {tuple(stack.shape)}")
    return gather_patches(stack, centers, radius)


def extract_windows(img, corners, window: int):
    """Integer-aligned (N, window, window) windows at top-left image coords
    `corners` (may be negative; edge padding absorbs out-of-image parts).
    Returns (windows, corners_eff (N, 2) int) — the clamped corners used."""
    h, w = img.shape
    pad = window
    cx = torch.clamp(corners[:, 0].long(), -pad, w)
    cy = torch.clamp(corners[:, 1].long(), -pad, h)
    wins = _gather_blocks(img, cx + pad, cy + pad, window, pad)
    return wins, torch.stack([cx, cy], dim=-1)


def equalize_hist(img):
    """Global 256-bin histogram equalization (cv::equalizeHist) over the
    last two dims; leading dims batch with an independent histogram each."""
    idx = torch.clamp(img, 0.0, 255.0).to(torch.int64)
    lead = img.shape[:-2]
    flat = idx.reshape(-1, img.shape[-2] * img.shape[-1])
    b = flat.shape[0]
    offs = flat + 256 * torch.arange(b, device=img.device)[:, None]
    hist = torch.bincount(offs.reshape(-1), minlength=256 * b).reshape(b, 256)
    cdf = torch.cumsum(hist.to(img.dtype), dim=-1)
    first = torch.argmax((cdf > 0).to(torch.int32), dim=-1, keepdim=True)
    cdf_min = torch.gather(cdf, -1, first)
    denom = torch.clamp(cdf[:, -1:] - cdf_min, min=1.0)
    lut = torch.clamp((cdf - cdf_min) / denom * 255.0, 0.0, 255.0)
    return torch.gather(lut, 1, flat).reshape(lead + img.shape[-2:])
