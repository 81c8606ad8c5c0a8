"""grad_blur: Scharr gx, gy and the 5-tap binomial pyrDown blur of a (B, H, W)
float32 stack, from one read of each image — one pyramid level.

Replaces the TPU kernel flvis_tpu/ops/pallas/gradpyr.py:grad_blur_pallas
(called once per pyramid level by image.build_grad_pyramid on the (3, H, W)
previous/left/right stack, every frame).

Three modes:
  "full" — (gx, gy, blur), all (B, H, W): the TPU kernel's contract;
  "next" — (gx, gy, next) with next = blur[..., ::2, ::2], the next level's
           (B, ceil(H/2), ceil(W/2)) image, written whole by the kernel;
  "none" — (gx, gy, None): the last level, no blur.
build_grad_pyramid runs "next" on every level but the last and "none" on
that, so a frame's pyramid is one launch per level and nothing else.

On the H100 the kernel (csrc/gradpyr.cu) is bound by bytes: 4 B read and
8 B written per pixel, +1 B for the quarter-size next level (13 B/px) or
+4 B in full mode; ~30 flops per pixel.  Each block stages a 64×16 tile
and its 2-px halo in shared memory (16-byte loads in interior tiles,
clamped loads — the edge-replicate border — only in border tiles); each
lane then walks two columns down an 8-row strip with the horizontal passes
in a register window, ~2 shared loads per output pixel.  Tap order and
weights follow gradpyr.py:53-76 / image.py:21,134-140; nvcc's FMA
contraction moves results by ~1e-5 on [0, 255] inputs, hence the 1e-3
tolerance against the plain version.
"""

from __future__ import annotations

import torch

from .. import image as imops
from . import _build

MODES = {"full": 0, "next": 1, "none": 2}


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"grad_blur: mode must be one of {tuple(MODES)}, got {mode!r}")


def grad_blur_plain(stack, mode: str = "full"):
    """Plain PyTorch version: scharr_gradients + the pyr_down low-pass; the
    "next" and "none" modes are slices of the full one."""
    _check_mode(mode)
    gx, gy = imops.scharr_gradients(stack)
    if mode == "none":
        return gx, gy, None
    blur = imops._sep_filter(stack, imops._PYR_K, imops._PYR_K)
    return gx, gy, blur[..., ::2, ::2].contiguous() if mode == "next" else blur


def grad_blur_kernel(stack, mode: str = "full"):
    """Launch csrc/gradpyr.cu on a contiguous (B, H, W) float32 CUDA stack."""
    _check_mode(mode)
    _build.require_cuda_f32("grad_blur", stack=stack)
    if stack.dim() != 3:
        raise ValueError(f"grad_blur: expected (B, H, W), got {tuple(stack.shape)}")
    B, H, W = stack.shape
    gx = torch.empty_like(stack)
    gy = torch.empty_like(stack)
    out = None
    if mode == "full":
        out = torch.empty_like(stack)
    elif mode == "next":
        out = torch.empty((B, (H + 1) // 2, (W + 1) // 2), dtype=stack.dtype, device=stack.device)
    lib, _ = _build.load_library()
    err = _build.launch_on(stack.get_device(), lib.flvis_grad_blur, stack.data_ptr(),
                           gx.data_ptr(), gy.data_ptr(), 0 if out is None else out.data_ptr(),
                           MODES[mode], B, H, W, _build.stream_of(stack))
    _build.check_launch("grad_blur", err)
    grad_blur_kernel.launches += 1
    return gx, gy, out


grad_blur_kernel.launches = 0


def grad_blur(stack, mode: str = "full"):
    """(B, H, W) → (gx, gy, blur | next | None) by `mode`.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (which raises on what
    it cannot take)."""
    if stack.is_cuda:
        return grad_blur_kernel(stack, mode)
    if stack.device.type == "cpu":
        return grad_blur_plain(stack, mode)
    raise ValueError(f"grad_blur: unsupported device {stack.device}")
