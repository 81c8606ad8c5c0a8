"""ORB features: FAST corners + intensity-centroid orientation + rotated
BRIEF descriptors, and Hamming matching (port of flvis_tpu/ops/orb.py).

Descriptors are (N, 8) int32 tensors holding the bit patterns of the
reference's packed uint32 words.  The TPU idioms carry over in their direct
form:
  - `approx_max_k` (orb.py:235) is the exact `torch.topk` (tie order may
    differ from the reference's, so callers compare keypoint sets);
  - the bf16 selection-matmul patch gather of `extract_patches_int(...,
    exact=False)` is the exact indexed gather of ops/image;
  - FAST + NMS + margin + blur go through ops/kernels/fastblur (the CUDA
    kernel on the card) and the Hamming matrix and the mutual-ratio matcher
    through ops/kernels/hamming.
"""

from __future__ import annotations

import numpy as np
import torch

from . import image as imops
from .kernels import hamming
from .kernels.fastblur import CIRCLE, fast_score_nms_blur
from .kernels.hamming import hamming_matrix

__all__ = ["fast_score", "orientations_from_patches", "brief_from_patches",
           "detect_and_compute", "hamming_matrix", "unpack_pm1", "pack_pm1",
           "mutual_ratio_match"]


def fast_score(img, threshold: float = 20.0):
    """FAST-9 corner response for every pixel, (H, W), with the reference's
    roll-wrap border (0 for non-corners, else the SAD of the ring beyond
    the threshold)."""
    ring = torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1)) for dx, dy in CIRCLE.tolist()])
    diff = ring - img[None]
    bright = diff > threshold
    dark = diff < -threshold

    def arc9(mask):
        acc = mask
        for k in range(1, 9):
            acc = acc & torch.roll(mask, -k, dims=0)
        return torch.any(acc, dim=0)

    is_corner = arc9(bright) | arc9(dark)
    score = torch.sum(torch.where(bright | dark, torch.abs(diff) - threshold, 0.0), dim=0)
    return torch.where(is_corner, score, 0.0)


def _moment_kernels(radius: int = 15):
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = (xs ** 2 + ys ** 2 <= radius ** 2).astype(np.float32)
    return (xs * disk).astype(np.float32), (ys * disk).astype(np.float32)


def orientations_from_patches(patches, radius: int | None = None):
    """Intensity-centroid angle atan2(m01, m10) from (N, S, S) patches; the
    full patch is the moment disk when radius is None."""
    S = patches.shape[-1]
    if radius is None:
        radius = (S - 1) // 2
    c = (S - (2 * radius + 1)) // 2
    p = patches[:, c:c + 2 * radius + 1, c:c + 2 * radius + 1]
    kx, ky = (torch.as_tensor(k, device=patches.device) for k in _moment_kernels(radius))
    m10 = torch.einsum("nyx,yx->n", p, kx)
    m01 = torch.einsum("nyx,yx->n", p, ky)
    return torch.atan2(m01, m10)


def _brief_pattern(num_pairs: int = 256, patch: int = 24, seed: int = 42):
    """Gaussian BRIEF sampling pairs (P, 4) = (x1, y1, x2, y2), clipped to
    ±patch/2 per coordinate and then to radius patch/2 (the reference's
    pattern, drawn from numpy with the same seed)."""
    rng = np.random.default_rng(seed)
    pat = rng.normal(0.0, patch / 5.0, size=(num_pairs, 4))
    pat = np.clip(pat, -patch / 2, patch / 2)
    for k in (0, 2):
        n = np.hypot(pat[:, k], pat[:, k + 1])
        scale = np.minimum(1.0, (patch / 2) / np.maximum(n, 1e-6))
        pat[:, k] *= scale
        pat[:, k + 1] *= scale
    return pat.astype(np.float32)


_PATTERN = _brief_pattern()
# Patch half-size of the shared orientation + BRIEF gather: rotated BRIEF
# support ≤ 12 plus 1 for bilinear interpolation.
_PATCH_R = 13


def _pack_bits(bits):
    """(N, 256) bool → (N, 8) int32 words (bit k of word w is bit 32w + k)."""
    b = bits.reshape(bits.shape[0], 8, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    words = torch.sum(b * weights, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def brief_from_patches(patches, angles):
    """Rotated BRIEF-256 from (N, S, S) blurred patches, packed (N, 8):
    the 512 rotated sample points are read inside the patches with bilinear
    hat weights."""
    r = (patches.shape[-1] - 1) // 2
    pat = torch.as_tensor(_PATTERN, device=patches.device)
    ca, sa = torch.cos(angles), torch.sin(angles)
    xs = torch.cat([pat[:, 0], pat[:, 2]])
    ys = torch.cat([pat[:, 1], pat[:, 3]])
    rx = ca[:, None] * xs[None, :] - sa[:, None] * ys[None, :]
    ry = sa[:, None] * xs[None, :] + ca[:, None] * ys[None, :]
    s = 2 * r + 1
    py = torch.clamp(ry + r, 0.0, s - 1.000001)
    px = torch.clamp(rx + r, 0.0, s - 1.000001)
    grid = torch.arange(s, dtype=torch.float32, device=patches.device)
    wy = torch.clamp(1.0 - torch.abs(grid[None, None, :] - py[..., None]), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(grid[None, None, :] - px[..., None]), min=0.0)
    rows = torch.einsum("npy,nyx->npx", wy, patches)
    samples = torch.sum(rows * wx, dim=-1)
    return _pack_bits(samples[:, :256] < samples[:, 256:])


def detect_and_compute(img, num_features: int = 500, threshold: float = 20.0):
    """ORB: FAST-9 + NMS → top-K by score → orientation → rBRIEF.
    Returns (uv (K, 2), desc (K, 8) int32, valid (K,), angles (K,));
    non-corners score 0 and are masked out."""
    if img.dtype != torch.float32:
        img = img.to(torch.float32)
    w = img.shape[1]
    score, blur = fast_score_nms_blur(img.contiguous(), threshold, margin=20)
    top_val, top_idx = torch.topk(score.reshape(-1), num_features)
    uv = torch.stack([(top_idx % w).to(torch.float32),
                      torch.div(top_idx, w, rounding_mode="floor").to(torch.float32)], -1)
    valid = top_val > 0.0
    patches = imops.extract_patches_int(blur, uv, _PATCH_R)
    ang = orientations_from_patches(patches)
    return uv, brief_from_patches(patches, ang), valid, ang


def unpack_pm1(desc, dtype=torch.float32):
    """(N, 8) packed words → (N, 256) ±1 (hamming = (256 − a·b)/2)."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(desc.shape[0], 256).to(dtype) * 2.0 - 1.0


def pack_pm1(pm1):
    """(N, 256) ±1 → (N, 8) packed words, the inverse of unpack_pm1 (+1 is
    a set bit)."""
    return _pack_bits(pm1 > 0)


def mutual_ratio_match(desc_a, desc_b, valid_a, valid_b, ratio: float = 0.75,
                       max_distance: int = 64):
    """Mutual-best kNN2 matching with the Lowe ratio test.  Returns
    (idx_b_for_a (Na,), good (Na,)): a batch of one pair of
    kernels.hamming.mutual_ratio_match."""
    best_ab, good = hamming.mutual_ratio_match(desc_a[None], desc_b[None], valid_a[None],
                                               valid_b[None], ratio, max_distance)[:2]
    return best_ab[0], good[0]
