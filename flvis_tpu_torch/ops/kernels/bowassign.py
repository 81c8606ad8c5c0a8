"""bow_tf: the bag-of-words term frequencies of B keyframes — for each
valid descriptor its nearest vocabulary word (lowest index among ties) and
the (B, V) histogram of those words.

Replaces the TPU kernel flvis_tpu/ops/pallas/bowassign.py:bow_tf_pallas
(one keyframe there; B keyframes here).  loop/bow.transform and
transform_rows route through it and apply idf and the L1 normalisation,
as the TPU kernel's caller does.

Inputs: (B, N, 8) int32 packed descriptors (the uint32 bit patterns of the
JAX package's words), (B, N) bool valid, and the vocabulary as (V, 8)
packed words.  Output: (B, V) int32 counts.  Words are exactly ±1 (the
majority vote of bow.train), so similarity = 256 − 2·Hamming and the
reference's argmax of the ±1 product is the argmin of the Hamming distance.

The plain version is that ±1 product: unpack, (N, 256) × (256, V) matmul
per keyframe, argmax, index_add_.  On the H100 the kernel
(csrc/bowassign.cu) computes the same product on the int8 tensor cores and
is bound by their operations (2·B·N·V·256): a block unpacks 64
descriptors into ±1 int8 rows held as mma fragments, streams the (V, 256)
int8 words (the Vocabulary's words_i8, or unpacked here from the packed
words) through shared memory in tiles of 128 with cp.async, and keeps a
running first maximum per row, merged on (similarity, lower index) at the
end; the counts are integer atomics.  No limit on V.  Integer and exact:
kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from ..orb import unpack_pm1
from . import _build


def bow_tf_plain(desc, valid, words_packed, words_pm1=None):
    """Plain PyTorch version: the ±1 matmul + argmax + index_add_, one
    keyframe at a time (bounds the (N, V) similarity to one row)."""
    if words_pm1 is None:
        words_pm1 = unpack_pm1(words_packed)
    B, N = valid.shape
    V = words_pm1.shape[0]
    tf = torch.zeros((B, V), dtype=torch.int32, device=desc.device)
    for b in range(B):
        sim = unpack_pm1(desc[b]) @ words_pm1.T
        sim = torch.where(valid[b][:, None], sim, -torch.inf)
        assign = torch.argmax(sim, dim=1)              # first index among ties
        tf[b].index_add_(0, torch.where(valid[b], assign, V - 1), valid[b].to(torch.int32))
    return tf


def _require(name, t, dtype):
    if not t.is_cuda:
        raise ValueError(f"bow_tf: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"bow_tf: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"bow_tf: {name} must be contiguous")


def bow_tf_kernel(desc, valid, words_packed, words_i8=None):
    """Launch csrc/bowassign.cu on (B, N, 8) int32 descriptors, (B, N) bool
    valid and the words, (V, 8) int32 packed and, when given, (V, 256) int8
    ±1 (else unpacked from the packed words), all contiguous CUDA tensors."""
    _require("desc", desc, torch.int32)
    _require("valid", valid, torch.bool)
    _require("words_packed", words_packed, torch.int32)
    if desc.dim() != 3 or desc.shape[2] != 8 or tuple(valid.shape) != tuple(desc.shape[:2]):
        raise ValueError(f"bow_tf: expected desc (B, N, 8) and valid (B, N), got "
                         f"{tuple(desc.shape)} and {tuple(valid.shape)}")
    if words_packed.dim() != 2 or words_packed.shape[1] != 8 or words_packed.shape[0] == 0:
        raise ValueError(f"bow_tf: words_packed must be (V, 8), V > 0, got "
                         f"{tuple(words_packed.shape)}")
    B, N = valid.shape
    V = words_packed.shape[0]
    if words_i8 is None:
        words_i8 = unpack_pm1(words_packed).to(torch.int8)
    _require("words_i8", words_i8, torch.int8)
    if tuple(words_i8.shape) != (V, 256):
        raise ValueError(f"bow_tf: words_i8 must be ({V}, 256), got {tuple(words_i8.shape)}")
    if len({desc.device, valid.device, words_packed.device, words_i8.device}) != 1:
        raise ValueError("bow_tf: tensors on several devices")
    tf = torch.zeros((B, V), dtype=torch.int32, device=desc.device)
    if B * N == 0:
        return tf
    lib, _ = _build.load_library()
    err = _build.launch_on(desc.get_device(), lib.flvis_bow_tf, desc.data_ptr(),
                           valid.data_ptr(), words_i8.data_ptr(), tf.data_ptr(), B, N, V,
                           _build.stream_of(desc))
    _build.check_launch("bow_tf", err)
    bow_tf_kernel.launches += 1
    return tf


bow_tf_kernel.launches = 0


def bow_tf(desc, valid, words_packed, words_pm1=None, words_i8=None):
    """CPU tensors take the plain version (using words_pm1 when given);
    CUDA tensors launch the kernel (using words_i8 when given), which raises
    on what it cannot take."""
    if desc.is_cuda:
        return bow_tf_kernel(desc, valid, words_packed, words_i8=words_i8)
    if desc.device.type == "cpu":
        return bow_tf_plain(desc, valid, words_packed, words_pm1)
    raise ValueError(f"bow_tf: unsupported device {desc.device}")
