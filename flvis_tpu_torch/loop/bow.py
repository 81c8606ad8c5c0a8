"""Bag-of-binary-words place recognition as dense linear algebra (port of
flvis_tpu/loop/bow.py).

Descriptors and words are ±1 vectors, so Hamming distance is
(256 − a·bᵀ)/2 and word assignment is an argmax of one (N, V) product;
tf-idf weighting and the normalised-L1 score (DBoW3's default) are dense
vector ops, and scoring one query against the keyframe database is one
batched reduction.

Random draws: `train`'s initial centroids (jax.random.choice in the
reference, bow.py:48-50) are the input `init_idx`; by default they come
from a torch.Generator seeded with `seed`, and the parity tests hand in
the reference's draw.  `transform` (one keyframe) and `transform_rows`
(B keyframes, the reference's `_bow_rows` scan) go through the bowassign
kernel (ops/kernels/bowassign.py) for the word assignment and term
frequencies — the reference's TPU kernel bow_tf_pallas, which it keeps
unrouted; on a CPU tensor its plain version, the matmul + argmax +
index_add_ — and apply idf and the L1 normalisation here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.kernels.bowassign import bow_tf
from ..ops.orb import pack_pm1, unpack_pm1
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class Vocabulary:
    words_pm1: torch.Tensor    # (V, 256) ±1 float — centroid bits
    idf: torch.Tensor          # (V,) inverse document frequency weights
    # (V, 8) int32: the words packed in ops/orb.unpack_pm1's bit order, and
    # (V, 256) int8: the words as ±1 bytes, the bowassign kernel's tensor-core
    # operand; both computed once from words_pm1.
    words_packed: torch.Tensor = dataclasses.field(init=False, repr=False)
    words_i8: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "words_packed", pack_pm1(self.words_pm1).contiguous())
        object.__setattr__(self, "words_i8", self.words_pm1.to(torch.int8).contiguous())


def _assign(d, words_pm1):
    return torch.argmax(d @ words_pm1.T, dim=1)     # first index among ties


def train(descriptors_packed, valid, num_words: int = 1024, iters: int = 8, seed: int = 0,
          init_idx=None) -> Vocabulary:
    """Binary k-means (majority-vote centroids) over the valid packed (N, 8)
    descriptors.  init_idx (num_words,) picks the initial centroids among
    the valid rows; without it they are drawn from a torch.Generator seeded
    with `seed` (with replacement when there are fewer rows than words)."""
    dev = descriptors_packed.device
    host = not torch.is_tensor(valid) or valid.device.type == "cpu"
    with profiling.host_sync("bow.train_upload", int(host)):    # from pageable host memory
        valid = torch.as_tensor(valid, device=dev)
    if not bool(profiling.host_read(valid.all(), site="bow.train_valid")):
        with profiling.host_sync("bow.train_select"):        # a boolean selection's size
            descriptors_packed = descriptors_packed[valid]
    d = unpack_pm1(descriptors_packed)                # (N, 256)
    n = d.shape[0]
    if init_idx is None:
        g = torch.Generator().manual_seed(seed)
        init_idx = (torch.randint(n, (num_words,), generator=g) if n < num_words
                    else torch.randperm(n, generator=g)[:num_words])
    with profiling.host_sync("bow.train_upload"):
        c = d[torch.as_tensor(init_idx, device=d.device).long()]
    for _ in range(iters):
        assign = _assign(d, c)
        sums = torch.zeros_like(c).index_add_(0, assign, d)
        with profiling.host_sync("bow.bincount"):         # bincount reads the largest index
            counts = torch.bincount(assign, minlength=num_words)[:, None]
        c = torch.where(counts > 0, torch.sign(sums + 0.5), c)
    df = torch.zeros(num_words, device=d.device).index_add_(
        0, _assign(d, c), torch.ones(n, device=d.device))
    with profiling.host_sync("bow.train_upload"):
        n_t = torch.tensor(float(n), device=d.device)
    idf = torch.log(torch.clamp(n_t, min=1.0) / torch.clamp(df, min=1.0))
    return Vocabulary(c, idf)


def save(path: str, vocab: Vocabulary) -> None:
    """Persist a vocabulary (.npz)."""
    np.savez_compressed(path, words_pm1=vocab.words_pm1.cpu().numpy(),
                        idf=vocab.idf.cpu().numpy())


def load(path: str, *, device) -> Vocabulary:
    data = np.load(path)
    return Vocabulary(torch.as_tensor(data["words_pm1"], device=device),
                      torch.as_tensor(data["idf"], device=device))


def transform_rows(vocab: Vocabulary, descriptors_packed, valid):
    """B keyframes' descriptors (B, N, 8) with (B, N) valid → their
    L1-normalised tf-idf BoW rows (B, V)."""
    tf = bow_tf(descriptors_packed.contiguous(), valid.contiguous(), vocab.words_packed,
                vocab.words_pm1, vocab.words_i8).to(torch.float32)
    v = tf * vocab.idf
    return v / torch.clamp(torch.sum(torch.abs(v), dim=1, keepdim=True), min=1e-9)


def transform(vocab: Vocabulary, descriptors_packed, valid):
    """Descriptors (N, 8) → L1-normalised tf-idf BoW vector (V,)."""
    return transform_rows(vocab, descriptors_packed[None], valid[None])[0]


def score(a, b):
    """L1 similarity of two normalised BoW vectors, 1 − ½‖a − b‖₁."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b))


def score_database(query, database, db_valid):
    """Similarity of one query against every database row (K, V) → (K,),
    invalid rows 0."""
    s = 1.0 - 0.5 * torch.sum(torch.abs(database - query[None, :]), dim=1)
    return torch.where(db_valid, s, 0.0)
