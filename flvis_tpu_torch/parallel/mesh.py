"""One named mesh axis over SPMD ranks, and its collectives.

The reference lays a `jax.sharding.Mesh` over one process's devices and
writes collectives inside `shard_map` bodies (`lax.psum`,
`lax.all_gather`, `lax.axis_index`).  In PyTorch the same program runs as
SPMD ranks: one process a device, joined by a `torch.distributed` process
group.  A `Mesh` here is a thin record over that group — its axis name
(`seq`, `lm` or `kf`), its size, this rank's index and this rank's device —
rather than a `DeviceMesh`: the collectives below move a handful of flat
tensors, and the record places ranks on any device, several ranks sharing
one card included.

The backend rule (`backend_for`) lives here and nowhere else: `nccl` when
every rank has a GPU of its own, `gloo` on the CPU and when ranks share a
card.  A gloo group carries CUDA tensors through host buffers (pinned
staging copies, `_stage`): that is the declared transport of the backend,
chosen by the group's backend, never by catching a failed collective.

`psum` gathers every rank's tensor and sums them in rank order, so every
rank gets the same bits and two runs of one tree give one answer; a mesh of
one rank makes every collective the identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis: str                       # "seq", "lm" or "kf"
    size: int                       # ranks on the axis
    rank: int                       # this rank's index on it
    device: torch.device            # this rank's device


def backend_for(device_type: str, ranks_per_host: int, gpus_per_host: int) -> str:
    """The process group's backend: "nccl" when every rank has a GPU of its
    own (CUDA ranks, no more of them on a host than GPUs), else "gloo" (CPU
    ranks, or CUDA ranks sharing a card)."""
    if device_type == "cuda" and 0 < ranks_per_host <= gpus_per_host:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of the rank with index `local_rank` on its host: the CPU,
    or GPU local_rank mod the host's GPU count."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device(device_type)


_RANK_DEVICE: list = []             # set by multihost.initialize: this rank's device


def make_mesh(axis: str, device=None) -> Mesh:
    """A mesh of every rank of the default process group on `axis` (one
    rank, no group, when none was initialised), on this rank's device —
    the one multihost.initialize chose, else `device` (default "cuda")."""
    dev = torch.device(device) if device is not None else (
        _RANK_DEVICE[0] if _RANK_DEVICE else torch.device("cuda"))
    if dist.is_available() and dist.is_initialized():
        return Mesh(axis, dist.get_world_size(), dist.get_rank(), dev)
    return Mesh(axis, 1, 0, dev)


def axis_size(mesh: Mesh) -> int:
    return mesh.size


def axis_index(mesh: Mesh) -> int:
    return mesh.rank


def block(mesh: Mesh, n: int) -> slice:
    """The rank's contiguous block of n items laid out on the axis
    (rank r holds [r·n/size, (r+1)·n/size)); n must divide evenly."""
    if n % mesh.size:
        raise ValueError(f"{n} items do not split over the {mesh.size} ranks of mesh axis "
                         f"'{mesh.axis}'")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def _backend(mesh: Mesh) -> str:
    return dist.get_backend()


def _stage(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x as the group's transport takes it: CUDA tensors through a pinned
    host copy for gloo, as they are for nccl; bools as uint8."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if x.is_cuda and _backend(mesh) == "gloo":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x.contiguous()


def all_gather(mesh: Mesh, x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
    """Every rank's x, in rank order, on x's device: concatenated on the
    leading axis (tiled, lax.all_gather(tiled=True)) or stacked on a new
    one."""
    if mesh.size == 1:
        return x if tiled else x[None]
    xs = _stage(mesh, x)
    parts = [torch.empty_like(xs) for _ in range(mesh.size)]
    dist.all_gather(parts, xs)
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return out.to(device=x.device, dtype=x.dtype)


def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's x (lax.psum), summed in rank order: the same
    bits on every rank and in every run."""
    if mesh.size == 1:
        return x
    parts = all_gather(mesh, x, tiled=False)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def all_gather_object(mesh: Mesh, obj) -> list:
    """Every rank's picklable `obj`, in rank order (results paths only)."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def barrier(mesh: Mesh) -> None:
    if mesh.size > 1:
        dist.barrier()
