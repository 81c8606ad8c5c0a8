"""grad_blur: Scharr gx, gy and the 5-tap binomial pyrDown blur of a (B, H, W)
float32 stack, from one read of each image.

Replaces the TPU kernel flvis_tpu/ops/pallas/gradpyr.py:grad_blur_pallas
(called once per pyramid level by image.build_grad_pyramid on the (3, H, W)
previous/left/right stack, every frame).

On the H100 the kernel (csrc/gradpyr.cu) is memory- and launch-bound: it
reads one float per pixel and writes three (16 B/pixel; the 480×752×3 level
moves ~17 MB, ~5 µs at 3.35 TB/s), and does ~40 flops per pixel.  The design
keeps the traffic at that minimum: each block stages a 32×16 output tile
plus a 2-px halo in shared memory with CLAMPED global indices — that is the
edge-replicate border, so the padded copy the TPU wrapper materialises
(gradpyr.py:97) never exists — and emits all three maps from the one
staged tile.  B rides gridDim.z, so the whole stack is one launch per level.
Tap order and weights follow gradpyr.py:53-76 / image.py:21,134-140; nvcc's
FMA contraction moves results by ~1e-5 on [0, 255] inputs, hence the 1e-3
tolerance against the plain version.
"""

from __future__ import annotations

import torch

from .. import image as imops
from . import _build


def grad_blur_plain(stack):
    """Plain PyTorch version: scharr_gradients + the pyr_down low-pass."""
    gx, gy = imops.scharr_gradients(stack)
    return gx, gy, imops._sep_filter(stack, imops._PYR_K, imops._PYR_K)


def grad_blur_kernel(stack):
    """Launch csrc/gradpyr.cu on a contiguous (B, H, W) float32 CUDA stack."""
    _build.require_cuda_f32("grad_blur", stack=stack)
    if stack.dim() != 3:
        raise ValueError(f"grad_blur: expected (B, H, W), got {tuple(stack.shape)}")
    B, H, W = stack.shape
    gx = torch.empty_like(stack)
    gy = torch.empty_like(stack)
    blur = torch.empty_like(stack)
    lib, _ = _build.load_library()
    with torch.cuda.device(stack.device):
        err = lib.flvis_grad_blur(stack.data_ptr(), gx.data_ptr(), gy.data_ptr(),
                                  blur.data_ptr(), B, H, W, _build.stream_of(stack))
    _build.check_launch("grad_blur", err)
    grad_blur_kernel.launches += 1
    return gx, gy, blur


grad_blur_kernel.launches = 0


def grad_blur(stack):
    """(B, H, W) → (gx, gy, blur5).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (which raises on what it cannot take)."""
    if stack.is_cuda:
        return grad_blur_kernel(stack)
    if stack.device.type == "cpu":
        return grad_blur_plain(stack)
    raise ValueError(f"grad_blur: unsupported device {stack.device}")
