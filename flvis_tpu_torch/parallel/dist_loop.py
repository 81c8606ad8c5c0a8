"""Keyframe-sharded place recognition: the BoW database over SPMD ranks
(port of flvis_tpu/parallel/dist_loop.py).

The (K, V) BoW database is split by rows over a `kf` mesh axis: rank r of
n keeps rows [r·K/n, (r+1)·K/n) and their validity.  Scoring a query is
each rank's L1 similarity over its own rows, all-gathered to the (K,)
scores; the best candidate is each rank's local argmax and one all-gather
of the n (value, global index) pairs, so what crosses between ranks per
query is O(K) scores or O(n) pairs, whatever the vocabulary size.
"""

from __future__ import annotations

import torch

from ..loop import bow
from . import mesh as mesh_m


def make_kf_mesh(device=None) -> mesh_m.Mesh:
    """Every rank of the process group on the `kf` axis."""
    return mesh_m.make_mesh("kf", device)


def shard_rows(mesh: mesh_m.Mesh, a):
    """The rank's contiguous block of a (K, ...) array's rows, on its device."""
    return a[mesh_m.block(mesh, a.shape[0])].to(mesh.device).clone()


def shard_db(mesh: mesh_m.Mesh, db, valid):
    """The rank's rows of a (K, V) database and of its (K,) validity."""
    return shard_rows(mesh, db), shard_rows(mesh, valid)


def row_range(mesh: mesh_m.Mesh, db_local) -> range:
    """The global row indices the rank's block holds."""
    k = db_local.shape[0]
    return range(mesh.rank * k, (mesh.rank + 1) * k)


def set_row(mesh: mesh_m.Mesh, db_local, k: int, row):
    """Write global row k: only its owning rank writes (in place).  Returns
    db_local."""
    rows = row_range(mesh, db_local)
    if k in rows:
        db_local[k - rows.start] = row
    return db_local


def get_row(mesh: mesh_m.Mesh, db_local, k: int):
    """Global row k on every rank: its owner's row, all-gathered."""
    rows = row_range(mesh, db_local)
    own = db_local[k - rows.start] if k in rows else torch.zeros_like(db_local[0])
    return mesh_m.all_gather(mesh, own, tiled=False)[k // db_local.shape[0]]


def score_database_sharded(mesh: mesh_m.Mesh, query, db_local, valid_local):
    """L1 BoW similarity of one query against every row → (K,) on every
    rank: each rank scores its own rows (bow.score_database), then one
    all-gather."""
    return mesh_m.all_gather(mesh, bow.score_database(query, db_local, valid_local))


def best_candidate_sharded(mesh: mesh_m.Mesh, query, db_local, valid_local, cand_local):
    """The top-scoring row under an eligibility mask (the temporal gates):
    each rank's argmax over its eligible rows, then one all-gather of the
    (value, global index) pairs; ties go to the lowest index, as
    jnp.argmax breaks them.  db_local, valid_local and cand_local are the
    rank's blocks.  Returns (best score, best index) as 0-d tensors."""
    s = bow.score_database(query, db_local, valid_local)
    s = torch.where(valid_local & cand_local, s, -torch.inf)
    i = torch.argmax(s)
    pair = torch.stack([s[i].to(torch.float64),
                        (i + row_range(mesh, db_local).start).to(torch.float64)])
    pairs = mesh_m.all_gather(mesh, pair, tiled=False)            # (n, 2)
    j = torch.argmax(pairs[:, 0])                                  # first max: lowest rank
    k_total = db_local.shape[0] * mesh.size
    return (pairs[j, 0].to(s.dtype),
            torch.clamp(pairs[j, 1].to(torch.int64), 0, k_total - 1))
