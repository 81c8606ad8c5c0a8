"""sweep_maps: half-resolution plane-sweep stereo — per pixel, the SAD of
L against R shifted right by d for d in [0, 64), box-summed over 9×9, the
argmin with a 3-point parabolic subpixel fit, the best cost, and the
ambiguity test against the best candidate more than 2 disparities away.

Replaces the TPU kernel flvis_tpu/ops/pallas/sweep.py:sweep_maps_pallas
(called from ops/stereo.disparity_sweep on every loop-node keyframe).

Semantics follow the TPU kernel (f32 throughout, not the XLA path's bf16
volume): R is edge-padded by d_max on the left, rows are edge-padded by 4,
the 9-tap box is factored as a 3-tap sum composed with a 3-tap sum dilated
by 3 (x first, then y), the first minimum wins, and the outputs of width
Wh − 8 are embedded with a 4-column invalid band (disparity and cost 0,
not ok) on each side.

On the H100 the kernel (csrc/sweep.cu) is bound by operations, not bytes:
0.7 MB of half-res images in and 1 MB of maps out, against ~40 flops per
pixel and disparity; on the SM the shared-memory traffic that feeds them
sets the pace.  The design holds no cost volume: a block of 128 threads
takes a 32×8 output tile and runs the disparities in chunks of 8, one
barrier a chunk.  The horizontal pass keeps each thread's L values in
registers and slides R by one column per disparity; the vertical pass
forms each vertical 3-tap sum once for two output rows; both add in this
module's order, so the costs are bit-equal.  The reduction over d runs
online in registers (first strict minimum, the costs beside it, a ring of
prefix minima for the best cost more than 2 disparities below, a running
minimum above), so the maps equal the plain version's bit for bit.
"""

from __future__ import annotations

import torch

from . import _build

D_MAX = 64


def _tap3(v, dim, d):
    n = v.shape[dim]
    return (v.narrow(dim, 0, n - 2 * d) + v.narrow(dim, d, n - 2 * d)
            + v.narrow(dim, 2 * d, n - 2 * d))


def box9(v, dim):
    """Exact 9-tap box sum along `dim`, valid region (the length shrinks by
    8): a 3-tap sum composed with a 3-tap sum dilated by 3."""
    return _tap3(_tap3(v, dim, 1), dim, 3)


def sweep_maps_plain(L, R, d_max: int = D_MAX):
    """Plain PyTorch version: (Hh, Wh) half-res pair → (disp_h, c_best, ok)."""
    Hh, Wh = L.shape
    rows = torch.clamp(torch.arange(-4, Hh + 4, device=L.device), 0, Hh - 1)
    cols = torch.clamp(torch.arange(-d_max, Wh, device=L.device), 0, Wh - 1)
    Lp = L[rows]
    Rp = R[rows][:, cols]
    vol = torch.stack([box9(box9(torch.abs(Lp - Rp[:, d_max - d:d_max - d + Wh]), 1), 0)
                       for d in range(d_max)])                # (D, Hh, Wh-8)
    c_best, best = torch.min(vol, dim=0)        # first minimum among ties
    d_idx = torch.arange(d_max, device=L.device)[:, None, None]
    zero = torch.zeros((), device=L.device)
    cm = torch.sum(torch.where(d_idx == best[None] - 1, vol, zero), dim=0)
    cp = torch.sum(torch.where(d_idx == best[None] + 1, vol, zero), dim=0)
    far = torch.abs(best[None] - d_idx) > 2
    c2 = torch.min(torch.where(far, vol, torch.full((), 3.0e38, device=L.device)), dim=0).values
    denom = cm + cp - 2.0 * c_best
    delta = torch.where(denom > 1e-3, 0.5 * (cm - cp) / torch.clamp(denom, min=1e-3), zero)
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)
    ok = (c2 > 1.05 * c_best + 1e-3) & (best > 0) & (best < d_max - 1)

    def emb(a):
        z = torch.zeros((Hh, 4), dtype=a.dtype, device=a.device)
        return torch.cat([z, a, z], dim=1)

    return emb(disp), emb(c_best), emb(ok)


def sweep_maps_kernel(L, R, d_max: int = D_MAX):
    """Launch csrc/sweep.cu on contiguous (Hh, Wh) float32 CUDA images."""
    _build.require_cuda_f32("sweep_maps", L=L, R=R)
    if L.dim() != 2 or L.shape != R.shape or L.shape[1] <= 8:
        raise ValueError(f"sweep_maps: expected two (Hh, Wh > 8) images, got "
                         f"{tuple(L.shape)} and {tuple(R.shape)}")
    if d_max != D_MAX:
        raise ValueError(f"sweep_maps: the kernel is built for d_max={D_MAX}")
    Hh, Wh = L.shape
    disp = torch.empty_like(L)
    cbest = torch.empty_like(L)
    ok = torch.empty((Hh, Wh), dtype=torch.bool, device=L.device)
    lib, _ = _build.load_library()
    with torch.cuda.device(L.device):
        err = lib.flvis_sweep_maps(L.data_ptr(), R.data_ptr(), disp.data_ptr(),
                                   cbest.data_ptr(), ok.data_ptr(), Hh, Wh,
                                   _build.stream_of(L))
    _build.check_launch("sweep_maps", err)
    sweep_maps_kernel.launches += 1
    return disp, cbest, ok


sweep_maps_kernel.launches = 0


def sweep_maps(L, R, d_max: int = D_MAX):
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (which raises on what it cannot take)."""
    if L.is_cuda:
        return sweep_maps_kernel(L, R, d_max)
    if L.device.type == "cpu":
        return sweep_maps_plain(L, R, d_max)
    raise ValueError(f"sweep_maps: unsupported device {L.device}")
