"""gather_windows: per-point (s, s) windows — or (C, s, s) blocks of a
channel stack — of an image seen through an edge-replicate border of
`pad` pixels, at top-left corners given in the padded image's coordinates
and clamped to [0, dim + 2·pad − s] like jax.lax.dynamic_slice.

Replaces the TPU kernel flvis_tpu/ops/pallas/gather.py:gather_windows
(the JAX package's LK patch and search-window gathers, image.py:252-283).
Here ops/image._gather_blocks routes every block gather through it: the
template blocks and search windows of every LK level (ops/lk.py) and the
ORB patches (ops/orb.py).

The plain version edge-pads the image and gathers with advanced indexing.
On the H100 the kernel (csrc/gather.cu) is a copy bound by its bytes —
N·C·s² floats written plus the window rows read — so its design is about
traffic: it reads the UNPADDED image at clamped addresses (the clamp is
the edge border), so the padded copy (two index_select launches and one
image-sized write per gather) never exists; one warp per point copies the
window row by row with coalesced reads and writes.  The copy is exact:
kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from . import _build


def _edge_index(n: int, r: int, device):
    return torch.clamp(torch.arange(-r, n + r, device=device), 0, n - 1)


def _clamp_corners(img, cx, cy, size: int, pad: int):
    hp, wp = img.shape[-2] + 2 * pad, img.shape[-1] + 2 * pad
    return (torch.clamp(cx.long(), 0, wp - size), torch.clamp(cy.long(), 0, hp - size))


def gather_windows_plain(img, cx, cy, size: int, pad: int):
    """Plain PyTorch version: edge-pad by `pad`, then an indexed gather."""
    cx, cy = _clamp_corners(img, cx, cy, size, pad)
    padded = img.index_select(-1, _edge_index(img.shape[-1], pad, img.device))
    padded = padded.index_select(-2, _edge_index(img.shape[-2], pad, img.device))
    ar = torch.arange(size, device=img.device)
    rows = (cy[:, None] + ar)[:, :, None]
    cols = (cx[:, None] + ar)[:, None, :]
    if img.dim() == 2:
        return padded[rows, cols]
    return padded[:, rows, cols].permute(1, 0, 2, 3)


def gather_windows_kernel(img, cx, cy, size: int, pad: int):
    """Launch csrc/gather.cu on a contiguous (H, W) or (C, H, W) float32
    CUDA image; corners (N,) of any integer type."""
    _build.require_cuda_f32("gather_windows", img=img)
    if img.dim() not in (2, 3):
        raise ValueError(f"gather_windows: expected (H, W) or (C, H, W), got "
                         f"{tuple(img.shape)}")
    if cx.shape != cy.shape or cx.dim() != 1 or cx.device != img.device:
        raise ValueError("gather_windows: cx, cy must be (N,) tensors on the image's device")
    H, W = img.shape[-2:]
    if pad < 0 or size <= 0 or size > min(H, W) + 2 * pad:
        raise ValueError(f"gather_windows: window {size} does not fit ({H}, {W}) padded "
                         f"by {pad}")
    C = 1 if img.dim() == 2 else img.shape[0]
    n = cx.shape[0]
    out_shape = (n, size, size) if img.dim() == 2 else (n, C, size, size)
    out = torch.empty(out_shape, dtype=torch.float32, device=img.device)
    if n == 0:
        return out
    cx, cy = (c.to(torch.int32).contiguous() for c in _clamp_corners(img, cx, cy, size, pad))
    lib, _ = _build.load_library()
    with torch.cuda.device(img.device):
        err = lib.flvis_gather_windows(img.data_ptr(), cx.data_ptr(), cy.data_ptr(),
                                       out.data_ptr(), n, C, H, W, size, pad,
                                       _build.stream_of(img))
    _build.check_launch("gather_windows", err)
    gather_windows_kernel.launches += 1
    return out


gather_windows_kernel.launches = 0


def gather_windows(img, cx, cy, size: int, pad: int):
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (which raises on what it cannot take)."""
    if img.is_cuda:
        return gather_windows_kernel(img, cx, cy, size, pad)
    if img.device.type == "cpu":
        return gather_windows_plain(img, cx, cy, size, pad)
    raise ValueError(f"gather_windows: unsupported device {img.device}")
