"""gather: per-point blocks of an image seen through an edge-replicate
border, in two modes.

  windows — (s, s) windows, or (C, s, s) blocks of C planes, at integer
    top-left corners given in the coordinates of the image padded by `pad`
    and clamped to [0, dim + 2·pad − s] like jax.lax.dynamic_slice;
  patches — bilinear (S, S) patches, S = 2r + 1, around float centres:
    the (S+1)² block at the centre's floor, blended with its fractions
    (ops/image.extract_patches / extract_patches_multi).

Replaces the TPU kernel flvis_tpu/ops/pallas/gather.py:gather_windows
(the JAX package's LK patch and search-window gathers, image.py:252-283).
ops/image routes every block gather through it: the template patches
(patches mode) and search windows of every LK level (ops/lk.py) and the ORB
patches (ops/orb.py).

The image is an (H, W) or (C, H, W) float32 tensor, or a sequence of up to
four (H, W) planes — LK passes its (img, gx, gy) planes so, and nothing
stacks them.  The plain versions edge-pad the image and gather with
advanced indexing; patches mode's plain version then blends the block
with `_blend4`.

On the H100 the kernel (csrc/gather.cu) is a copy bound by its bytes and,
at the path's 0.2–1.5 MB, by launch latency, so its design is about both:
it reads the UNPADDED planes at clamped addresses (the clamp is the edge
border), so no padded or stacked copy exists; its grid runs over the
outputs, four consecutive outputs per thread with one vector store, so 256
points fill the card; and it takes the corners or centres as the callers
hold them (int64, float32, any stride) and clamps them itself, so the
wrapper does no tensor work before the launch beyond allocating the output.
The patches mode rounds every product and sum on its own in the plain
order.  Kernel and plain version agree bit for bit in both modes.
"""

from __future__ import annotations

import torch

from . import _build


def _edge_index(n: int, r: int, device):
    return torch.clamp(torch.arange(-r, n + r, device=device), 0, n - 1)


def _as_image(img):
    """A sequence of (H, W) planes as one (C, H, W) tensor (plain path)."""
    return img if isinstance(img, torch.Tensor) else torch.stack(list(img))


def _clamp_corners(img, cx, cy, size: int, pad: int):
    hp, wp = img.shape[-2] + 2 * pad, img.shape[-1] + 2 * pad
    return (torch.clamp(cx.long(), 0, wp - size), torch.clamp(cy.long(), 0, hp - size))


def gather_windows_plain(img, cx, cy, size: int, pad: int):
    """Plain PyTorch version: edge-pad by `pad`, then an indexed gather."""
    img = _as_image(img)
    cx, cy = _clamp_corners(img, cx, cy, size, pad)
    padded = img.index_select(-1, _edge_index(img.shape[-1], pad, img.device))
    padded = padded.index_select(-2, _edge_index(img.shape[-2], pad, img.device))
    ar = torch.arange(size, device=img.device)
    rows = (cy[:, None] + ar)[:, :, None]
    cols = (cx[:, None] + ar)[:, None, :]
    if img.dim() == 2:
        return padded[rows, cols]
    return padded[:, rows, cols].permute(1, 0, 2, 3)


def _subpixel_corners(centers, h: int, w: int, radius: int, pad: int):
    x = torch.clamp(centers[:, 0], -1.0, w * 1.0)
    y = torch.clamp(centers[:, 1], -1.0, h * 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return (x0.long() - radius + pad, y0.long() - radius + pad, x - x0, y - y0)


def _blend4(P, fx, fy):
    return (P[..., :-1, :-1] * (1 - fx) * (1 - fy) + P[..., :-1, 1:] * fx * (1 - fy)
            + P[..., 1:, :-1] * (1 - fx) * fy + P[..., 1:, 1:] * fx * fy)


def gather_patches_plain(img, centers, radius: int):
    """Plain PyTorch version of patches mode: the (S+1)² block gather at
    the centres' floors, then the 4-tap bilinear blend with each point's
    fractions."""
    img = _as_image(img)
    pad = radius + 2
    xi, yi, fx, fy = _subpixel_corners(centers, img.shape[-2], img.shape[-1], radius, pad)
    P = gather_windows_plain(img, xi, yi, 2 * radius + 2, pad)
    lead = (slice(None),) + (None,) * (P.dim() - 1)
    return _blend4(P, fx[lead], fy[lead])


def _planes(name: str, img):
    """(device index, pointers of four planes — 0 past the C-th —, C, H, W,
    out_prefix) of a CUDA image, checked for what the kernel takes."""
    if isinstance(img, torch.Tensor):
        if not (img.is_cuda and img.dtype == torch.float32 and img.is_contiguous()):
            _build.require_cuda_f32(name, img=img)          # raises with the reason
        if img.dim() == 2:
            (H, W), C, prefix = img.shape, 1, ()
        elif img.dim() == 3:
            C, H, W = img.shape
            prefix = (C,)
        else:
            raise ValueError(f"{name}: expected (H, W) or (C, H, W), got {tuple(img.shape)}")
        base, step = img.data_ptr(), H * W * 4
        ptrs = [base + c * step if c < C else 0 for c in range(4)]
        index = img.get_device()
    else:
        planes = tuple(img)
        if not all(p.is_cuda and p.dtype == torch.float32 and p.is_contiguous()
                   and p.get_device() == planes[0].get_device() for p in planes):
            _build.require_cuda_f32(name, **{f"plane{c}": p for c, p in enumerate(planes)})
        if not planes or any(p.dim() != 2 or p.shape != planes[0].shape for p in planes):
            raise ValueError(f"{name}: planes must be (H, W) tensors of one shape")
        H, W = planes[0].shape
        C = len(planes)
        ptrs = [p.data_ptr() for p in planes] + [0] * (4 - C)
        prefix = (C,)
        index = planes[0].get_device()
    if not 1 <= C <= 4:
        raise ValueError(f"{name}: {C} planes, the kernel takes 1 to 4")
    return index, ptrs, C, H, W, prefix


def _device_of(img):
    return img.device if isinstance(img, torch.Tensor) else img[0].device


def gather_windows_kernel(img, cx, cy, size: int, pad: int):
    """Launch csrc/gather.cu in windows mode on a CUDA image (see _planes);
    corners (N,) int64 on its device, any stride."""
    index, ptrs, C, H, W, prefix = _planes("gather_windows", img)
    if (cx.dtype != torch.int64 or cy.dtype != torch.int64 or cx.get_device() != index
            or cy.get_device() != index or cx.dim() != 1 or cx.shape != cy.shape):
        raise ValueError("gather_windows: cx, cy must be (N,) int64 tensors on the image's "
                         "device")
    if pad < 0 or size <= 0 or size > min(H, W) + 2 * pad:
        raise ValueError(f"gather_windows: window {size} does not fit ({H}, {W}) padded "
                         f"by {pad}")
    n = cx.shape[0]
    out = torch.empty((n, *prefix, size, size), dtype=torch.float32, device=cx.device)
    if n == 0:
        return out
    lib, _ = _build.load_library()
    err = _build.launch_on(index, lib.flvis_gather_windows, *ptrs, C, H, W, cx.data_ptr(),
                           cx.stride(0), cy.data_ptr(), cy.stride(0), out.data_ptr(), n, size,
                           pad, torch._C._cuda_getCurrentRawStream(index))
    _build.check_launch("gather_windows", err)
    gather_windows_kernel.launches += 1
    return out


# One count for both modes: each launch replaces one TPU gather.
gather_windows_kernel.launches = 0


def gather_patches_kernel(img, centers, radius: int):
    """Launch csrc/gather.cu in patches mode on a CUDA image (see _planes);
    centres (N, 2) float32 [x, y] on its device, any strides."""
    index, ptrs, C, H, W, prefix = _planes("gather_patches", img)
    if (centers.dtype != torch.float32 or centers.get_device() != index or centers.dim() != 2
            or centers.shape[1] != 2):
        raise ValueError("gather_patches: centers must be an (N, 2) float32 tensor on the "
                         "image's device")
    if radius < 0:
        raise ValueError(f"gather_patches: radius {radius} < 0")
    n, s = centers.shape[0], 2 * radius + 1
    out = torch.empty((n, *prefix, s, s), dtype=torch.float32, device=centers.device)
    if n == 0:
        return out
    lib, _ = _build.load_library()
    err = _build.launch_on(index, lib.flvis_gather_patches, *ptrs, C, H, W, centers.data_ptr(),
                           centers.stride(0), centers.stride(1), out.data_ptr(), n, radius,
                           torch._C._cuda_getCurrentRawStream(index))
    _build.check_launch("gather_patches", err)
    gather_windows_kernel.launches += 1
    return out


def gather_windows(img, cx, cy, size: int, pad: int):
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (which raises on what it cannot take)."""
    kind = _device_of(img).type
    if kind == "cuda":
        return gather_windows_kernel(img, cx, cy, size, pad)
    if kind == "cpu":
        return gather_windows_plain(img, cx, cy, size, pad)
    raise ValueError(f"gather_windows: unsupported device {_device_of(img)}")


def gather_patches(img, centers, radius: int):
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (which raises on what it cannot take)."""
    kind = _device_of(img).type
    if kind == "cuda":
        return gather_patches_kernel(img, centers, radius)
    if kind == "cpu":
        return gather_patches_plain(img, centers, radius)
    raise ValueError(f"gather_patches: unsupported device {_device_of(img)}")
