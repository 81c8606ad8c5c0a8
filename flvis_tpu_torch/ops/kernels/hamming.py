"""hamming_matrix: (Na, Nb) Hamming distances between packed 256-bit ORB
descriptors.

Replaces the TPU kernel flvis_tpu/ops/pallas/hamming.py:hamming_matrix_pallas
(routed from ops/orb.hamming_matrix; the loop node's mutual-ratio matcher
calls it on every geometric verification, 1000 × 1000 descriptors).

Descriptors are (N, 8) int32 tensors holding the uint32 bit patterns of the
JAX package's packed words (torch has no general uint32 arithmetic).

On the H100 the kernel (csrc/hamming.cu) is bound by its output: 1000² int32
distances are 4 MB to write (~1.2 µs at 3.35 TB/s) against 8 KB of
descriptors in; the 8 XOR + POPC per distance are cheap integer work.  The
TPU's ±1 matmul exists for its matrix unit; here each thread XORs and
popcounts 8 word pairs from shared-memory tiles of A and B, with writes
coalesced along B.  On a CUDA tensor every call goes to the kernel — the
reference's 128² size threshold is a TPU tiling artefact.  Integer and
exact: kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from . import _build

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def popcount32(x):
    """Population count of each int32 word (its uint32 bit pattern)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix_plain(desc_a, desc_b):
    """Plain PyTorch version: XOR + popcount over the 8 words."""
    x = torch.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return torch.sum(popcount32(x), dim=-1).to(torch.int32)


def hamming_matrix_kernel(desc_a, desc_b):
    """Launch csrc/hamming.cu on contiguous (N, 8) int32 CUDA tensors."""
    for name, t in (("desc_a", desc_a), ("desc_b", desc_b)):
        if not t.is_cuda:
            raise ValueError(f"hamming_matrix: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"hamming_matrix: {name} must be int32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != 8 or t.shape[0] == 0:
            raise ValueError(f"hamming_matrix: {name} must be (N, 8), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"hamming_matrix: {name} must be contiguous")
    if desc_a.device != desc_b.device:
        raise ValueError("hamming_matrix: descriptors on two devices")
    na, nb = desc_a.shape[0], desc_b.shape[0]
    out = torch.empty((na, nb), dtype=torch.int32, device=desc_a.device)
    lib, _ = _build.load_library()
    with torch.cuda.device(desc_a.device):
        err = lib.flvis_hamming_matrix(desc_a.data_ptr(), desc_b.data_ptr(), out.data_ptr(),
                                       na, nb, _build.stream_of(desc_a))
    _build.check_launch("hamming_matrix", err)
    hamming_matrix_kernel.launches += 1
    return out


hamming_matrix_kernel.launches = 0


def hamming_matrix(desc_a, desc_b):
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (which raises on what it cannot take)."""
    if desc_a.is_cuda:
        return hamming_matrix_kernel(desc_a, desc_b)
    if desc_a.device.type == "cpu":
        return hamming_matrix_plain(desc_a, desc_b)
    raise ValueError(f"hamming_matrix: unsupported device {desc_a.device}")
