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
the reference's draw.  `transform` stays a matmul + argmax + index_add_,
outside any hand-written kernel (the reference computes it outside Pallas
too: its bowassign kernel is not routed).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.orb import unpack_pm1


@dataclasses.dataclass(frozen=True)
class Vocabulary:
    words_pm1: torch.Tensor    # (V, 256) ±1 float — centroid bits
    idf: torch.Tensor          # (V,) inverse document frequency weights


def _assign(d, words_pm1):
    return torch.argmax(d @ words_pm1.T, dim=1)     # first index among ties


def train(descriptors_packed, valid, num_words: int = 1024, iters: int = 8, seed: int = 0,
          init_idx=None) -> Vocabulary:
    """Binary k-means (majority-vote centroids) over the valid packed (N, 8)
    descriptors.  init_idx (num_words,) picks the initial centroids among
    the valid rows; without it they are drawn from a torch.Generator seeded
    with `seed` (with replacement when there are fewer rows than words)."""
    valid = torch.as_tensor(valid, device=descriptors_packed.device)
    if not bool(valid.all()):
        descriptors_packed = descriptors_packed[valid]
    d = unpack_pm1(descriptors_packed)                # (N, 256)
    n = d.shape[0]
    if init_idx is None:
        g = torch.Generator().manual_seed(seed)
        init_idx = (torch.randint(n, (num_words,), generator=g) if n < num_words
                    else torch.randperm(n, generator=g)[:num_words])
    c = d[torch.as_tensor(init_idx, device=d.device).long()]
    for _ in range(iters):
        assign = _assign(d, c)
        sums = torch.zeros_like(c).index_add_(0, assign, d)
        counts = torch.bincount(assign, minlength=num_words)[:, None]
        c = torch.where(counts > 0, torch.sign(sums + 0.5), c)
    df = torch.zeros(num_words, device=d.device).index_add_(
        0, _assign(d, c), torch.ones(n, device=d.device))
    idf = torch.log(torch.clamp(torch.tensor(float(n), device=d.device), min=1.0)
                    / torch.clamp(df, min=1.0))
    return Vocabulary(c, idf)


def save(path: str, vocab: Vocabulary) -> None:
    """Persist a vocabulary (.npz)."""
    np.savez_compressed(path, words_pm1=vocab.words_pm1.cpu().numpy(),
                        idf=vocab.idf.cpu().numpy())


def load(path: str, *, device) -> Vocabulary:
    data = np.load(path)
    return Vocabulary(torch.as_tensor(data["words_pm1"], device=device),
                      torch.as_tensor(data["idf"], device=device))


def transform(vocab: Vocabulary, descriptors_packed, valid):
    """Descriptors → L1-normalised tf-idf BoW vector (V,)."""
    V = vocab.words_pm1.shape[0]
    sim = unpack_pm1(descriptors_packed) @ vocab.words_pm1.T
    sim = torch.where(valid[:, None], sim, -torch.inf)
    assign = torch.argmax(sim, dim=1)
    tf = torch.zeros(V, device=sim.device).index_add_(
        0, torch.where(valid, assign, V - 1), valid.to(torch.float32))
    v = tf * vocab.idf
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def score(a, b):
    """L1 similarity of two normalised BoW vectors, 1 − ½‖a − b‖₁."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b))


def score_database(query, database, db_valid):
    """Similarity of one query against every database row (K, V) → (K,),
    invalid rows 0."""
    s = 1.0 - 0.5 * torch.sum(torch.abs(database - query[None, :]), dim=1)
    return torch.where(db_valid, s, 0.0)
