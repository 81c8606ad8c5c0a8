"""Hamming distances between packed 256-bit ORB descriptors, and the loop
node's mutual-ratio matcher over a bucket of candidate pairs.

Replaces the TPU kernel flvis_tpu/ops/pallas/hamming.py:hamming_matrix_pallas
and, around it, its only caller flvis_tpu/ops/orb.py:mutual_ratio_match (the
loop node's geometric verification matches 1000 × 1000 descriptors a
candidate pair, 8 pairs a bucket).

Descriptors are (..., N, 8) int32 tensors holding the uint32 bit patterns of
the JAX package's packed words (torch has no general uint32 arithmetic).

Two modes of csrc/hamming.cu, each with its plain PyTorch version (the CPU
path and the kernel's oracle) and its launch count:
  - matrix mode, `hamming_matrix`: (Na, Nb) int32 distances, the TPU
    kernel's function, 64 × 128 tiles on the same binary path, bound by its
    4 MB output at 1000 × 1000;
  - match mode, `mutual_ratio_match`: the whole matcher over B pairs in one
    launch (the distances on the tensor cores' binary path, each row's top
    2 and each column's argmin as packed (distance, index) keys, then the
    mutual and ratio tests in each pair's last block), the (B, Na, Nb)
    matrix never written.
On a CUDA tensor every call goes to the kernel (the reference's 128² size
threshold is a TPU tiling artefact) and raises on what it cannot take.
Integer and exact: kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from ..features import stable_topk
from . import _build

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F
FAR = 512                 # the distance of a pair with an invalid side
MAX_N = (1 << 21) - 2     # match mode: indices are packed into 21 bits (all ones: padding)


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


def _require_desc(name, t, rank):
    if not t.is_cuda:
        raise ValueError(f"{name}: must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: must be int32, got {t.dtype}")
    if t.dim() != rank or t.shape[-1] != 8 or t.shape[-2] == 0:
        lead = "(N, 8)" if rank == 2 else "(B, N, 8)"
        raise ValueError(f"{name}: must be {lead}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def hamming_matrix_kernel(desc_a, desc_b):
    """Launch csrc/hamming.cu's matrix mode on contiguous (N, 8) int32 CUDA
    tensors (the kernel reads them a word at a time)."""
    _require_desc("hamming_matrix: desc_a", desc_a, 2)
    _require_desc("hamming_matrix: desc_b", desc_b, 2)
    if desc_a.device != desc_b.device:
        raise ValueError("hamming_matrix: descriptors on two devices")
    na, nb = desc_a.shape[0], desc_b.shape[0]
    out = torch.empty((na, nb), dtype=torch.int32, device=desc_a.device)
    lib, _ = _build.load_library()
    err = _build.launch_on(desc_a.get_device(), lib.flvis_hamming_matrix, desc_a.data_ptr(),
                           desc_b.data_ptr(), out.data_ptr(), na, nb, _build.stream_of(desc_a))
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


def mutual_ratio_match_plain(desc_a, desc_b, valid_a, valid_b, ratio: float = 0.75,
                             max_distance: int = 64):
    """Mutual-best kNN2 matching with the Lowe ratio test over B pairs:
    desc_a (B, Na, 8), desc_b (B, Nb, 8), valid_a (B, Na), valid_b (B, Nb).
    Returns (best_ab (B, Na), good (B, Na), d1, d2 (B, Na) int32, best_ba
    (B, Nb)); indices int64.  The distance matrix is made one pair at a
    time."""
    d = torch.stack([hamming_matrix_plain(a, b) for a, b in zip(desc_a, desc_b)])
    d = torch.where(valid_a[:, :, None] & valid_b[:, None, :], d, FAR)
    neg_top2, idx_top2 = stable_topk(-d, 2)
    best_ab = idx_top2[..., 0]
    d1 = -neg_top2[..., 0]
    d2 = -neg_top2[..., 1]
    best_ba = torch.argmin(d, dim=1)
    mutual = torch.gather(best_ba, 1, best_ab) == torch.arange(d.shape[1], device=d.device)
    good = (valid_a & mutual & (d1 <= max_distance)
            & (d1.to(torch.float32) < ratio * torch.clamp(d2, min=1).to(torch.float32)))
    return best_ab, good, d1, d2, best_ba


def mutual_ratio_match_kernel(desc_a, desc_b, valid_a, valid_b, ratio: float = 0.75,
                              max_distance: int = 64):
    """Launch csrc/hamming.cu's match mode (one kernel) on contiguous CUDA
    tensors: int32 (B, Na, 8) and (B, Nb, 8) descriptors, bool (B, Na) and
    (B, Nb) validity, Na ≤ MAX_N and 2 ≤ Nb ≤ MAX_N (2,097,150); desc_b 16-byte
    aligned (the kernel stages it with 16-byte loads).  Outputs as the plain
    version's."""
    _require_desc("mutual_ratio_match: desc_a", desc_a, 3)
    _require_desc("mutual_ratio_match: desc_b", desc_b, 3)
    B, na, nb = desc_a.shape[0], desc_a.shape[1], desc_b.shape[1]
    if desc_b.shape[0] != B:
        raise ValueError(f"mutual_ratio_match: {B} and {desc_b.shape[0]} pairs")
    for name, t, n in (("valid_a", valid_a, na), ("valid_b", valid_b, nb)):
        if t.dtype != torch.bool:
            raise ValueError(f"mutual_ratio_match: {name} must be bool, got {t.dtype}")
        if tuple(t.shape) != (B, n):
            raise ValueError(f"mutual_ratio_match: {name} must be {(B, n)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"mutual_ratio_match: {name} must be contiguous")
    if len({t.device for t in (desc_a, desc_b, valid_a, valid_b)}) != 1:
        raise ValueError("mutual_ratio_match: tensors on several devices")
    if desc_b.data_ptr() % 16:
        raise ValueError("mutual_ratio_match: desc_b must be 16-byte aligned")
    if na > MAX_N or not 2 <= nb <= MAX_N or B > 65535:
        raise ValueError(f"mutual_ratio_match: needs Na ≤ {MAX_N}, 2 ≤ Nb ≤ {MAX_N} and "
                         f"B ≤ 65535, got B={B}, Na={na}, Nb={nb}")
    dev = desc_a.device
    lib, _ = _build.load_library()
    best_ab = torch.empty((B, na), dtype=torch.int64, device=dev)
    good = torch.empty((B, na), dtype=torch.bool, device=dev)
    d1 = torch.empty((B, na), dtype=torch.int32, device=dev)
    d2 = torch.empty((B, na), dtype=torch.int32, device=dev)
    best_ba = torch.empty((B, nb), dtype=torch.int64, device=dev)
    stream = _build.stream_of(desc_a)
    colkey, tickets = _scratch(dev, stream, B, nb)
    err = _build.launch_on(desc_a.get_device(), lib.flvis_hamming_match, desc_a.data_ptr(),
                           desc_b.data_ptr(), valid_a.data_ptr(), valid_b.data_ptr(),
                           best_ab.data_ptr(), d1.data_ptr(), d2.data_ptr(), best_ba.data_ptr(),
                           good.data_ptr(), colkey.data_ptr(), tickets.data_ptr(), B, na, nb,
                           float(ratio), int(max_distance), stream)
    _build.check_launch("mutual_ratio_match", err)
    mutual_ratio_match_kernel.launches += 1
    return best_ab, good, d1, d2, best_ba


mutual_ratio_match_kernel.launches = 0
_SCRATCH: dict = {}


def _scratch(device, stream: int, B: int, nb: int):
    """The match mode's scratch on `stream` of `device`: (column keys, at
    least B·nb int32 at INT_MAX; last-block tickets, one a pair, at 0), made
    on that stream at first use or when a larger bucket comes.  Every
    launch leaves both as it found them."""
    key = (device.index, stream)
    colkey, tickets = _SCRATCH.get(key, (None, None))
    if colkey is None or colkey.numel() < B * nb:
        colkey = torch.full((max(B * nb, 8 * 1024),), torch.iinfo(torch.int32).max,
                            dtype=torch.int32, device=device)
    if tickets is None or tickets.numel() < B:
        tickets = torch.zeros(max(B, 8), dtype=torch.int32, device=device)
    _SCRATCH[key] = colkey, tickets
    return colkey, tickets


def mutual_ratio_match(desc_a, desc_b, valid_a, valid_b, ratio: float = 0.75,
                       max_distance: int = 64):
    """The batched matcher: CPU tensors take the plain version; CUDA tensors
    launch the kernel (which raises on what it cannot take)."""
    if desc_a.is_cuda:
        return mutual_ratio_match_kernel(desc_a, desc_b, valid_a, valid_b, ratio, max_distance)
    if desc_a.device.type == "cpu":
        return mutual_ratio_match_plain(desc_a, desc_b, valid_a, valid_b, ratio, max_distance)
    raise ValueError(f"mutual_ratio_match: unsupported device {desc_a.device}")
