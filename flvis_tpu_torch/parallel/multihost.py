"""Several processes, one program: process-group wiring and host-local
work (port of flvis_tpu/parallel/multihost.py).

The reference runs one JAX program over every host's devices:
`jax.distributed.initialize` joins the processes and a global mesh carries
the `seq` axis.  Here every rank is one process with one device, joined by
a `torch.distributed` process group (parallel/mesh.py: the backend rule,
the collectives).  Each rank loads and keeps only its own block of
sequences (`host_sequence_slice`); image streams never cross processes,
and the multi-sequence programs run no collective in steady state.

Launch: `torchrun --nproc-per-node N -m flvis_tpu_torch.run_multiseq
--mesh` (`initialize()` reads torchrun's RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, LOCAL_RANK and LOCAL_WORLD_SIZE), or
`initialize("host0:29500", N, rank)` in each process by hand, or
`spawn(fn, N)` from one Python process (what the tests, the entry point's
dry run and chip_smoke.py do).
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as mesh_m

TIMEOUT_S = 600                     # a collective waiting longer fails the rank


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def initialize(coordinator_address: str | None = None, num_processes: int = 1,
               process_id: int = 0, *, device_type: str = "cuda",
               local_rank: int | None = None, ranks_per_host: int | None = None) -> None:
    """Join this process to the process group of `num_processes` ranks.

    A single process is a no-op (no group, every collective the identity).
    Several need `coordinator_address` ("host:port", reachable from every
    process) and raise ValueError without one.  Under torchrun (WORLD_SIZE
    in the environment) the arguments come from its environment.  The
    backend follows mesh.backend_for over `device_type` (ranks_per_host
    defaults to every rank on one host); the rank's device is GPU
    local_rank mod the host's GPU count, or the CPU.  Prints the group's
    backend, world size and this rank's device."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        num_processes, process_id = _env_int("WORLD_SIZE", 1), _env_int("RANK", 0)
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
        local_rank = _env_int("LOCAL_RANK", process_id)
        ranks_per_host = _env_int("LOCAL_WORLD_SIZE", num_processes)
    if num_processes <= 1:
        return
    if coordinator_address is None:
        raise ValueError("multi-process runs need coordinator_address (host:port reachable "
                         "from every process)")
    local_rank = process_id if local_rank is None else local_rank
    ranks_per_host = num_processes if ranks_per_host is None else ranks_per_host
    gpus = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda" and gpus == 0:
        raise RuntimeError("initialize(device_type='cuda'): no CUDA device is visible")
    backend = mesh_m.backend_for(device_type, ranks_per_host, gpus)
    device = mesh_m.rank_device(device_type, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=TIMEOUT_S))
    mesh_m._RANK_DEVICE[:] = [device]
    print(f"process group: backend {dist.get_backend()}, world size "
          f"{dist.get_world_size()}, rank {dist.get_rank()} on {device}", flush=True)


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    mesh_m._RANK_DEVICE[:] = []


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes trajectories and results."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def host_sequence_slice(num_seqs: int, mesh: mesh_m.Mesh) -> slice:
    """The contiguous block of sequence indices this rank loads: rank r of
    n holds [r·S/n, (r+1)·S/n).  num_seqs must divide by the axis size (pad
    the run list — 11 EuRoC runs into 12 slots)."""
    if num_seqs % mesh.size:
        raise ValueError(f"num_seqs={num_seqs} not divisible by mesh axis size {mesh.size}; "
                         "pad the sequence list")
    return mesh_m.block(mesh, num_seqs)


def make_global_batch(mesh: mesh_m.Mesh, local_batch):
    """This rank's block of a batch, on its device.  PyTorch has no global
    array spanning processes: the (S_local, ...) leaves of `local_batch`
    (host arrays or tensors, the rank's host_sequence_slice) are what this
    rank's programs take, and they never leave it."""
    def put(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return t.to(mesh.device)

    if isinstance(local_batch, (tuple, list)):
        return type(local_batch)(put(a) for a in local_batch)
    return put(local_batch)


def gather_to_host(mesh: mesh_m.Mesh, x) -> np.ndarray:
    """Every rank's (S_local, ...) block, all-gathered in rank order, as one
    (S, ...) host array on every rank — the results path only (trajectory
    exports), never the frame loop.  A collective: every rank calls it."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return mesh_m.all_gather(mesh, t.to(mesh.device), tiled=True).cpu().numpy()


# ----------------------------------------------------------------- spawning
def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, n, port, device_type, args, out_dir, threads):
    if threads:
        torch.set_num_threads(threads)
    initialize(f"127.0.0.1:{port}", n, rank, device_type=device_type)
    mesh_m._RANK_DEVICE[:] = [mesh_m.rank_device(device_type, rank)]
    try:
        result = fn(*args)
        if device_type == "cuda":
            torch.cuda.synchronize()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        mesh_m.barrier(mesh_m.make_mesh("world"))
    finally:
        shutdown()


def spawn(fn, n: int, args=(), *, device_type: str = "cuda", threads: int | None = None) -> list:
    """Run fn(*args) on n ranks, each a fresh process in the process group
    of the n (127.0.0.1, a free port; backend by mesh.backend_for), and
    return the ranks' results in rank order.  fn must be importable by the
    new processes (a module-level function) and its result picklable.  A
    rank that raises or dies ends the others and raises here.  threads: the
    ranks' intra-op CPU threads (torch.set_num_threads), when given."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="flvis_ranks_") as out_dir:
        mp.spawn(_rank_main, args=(fn, n, free_port(), device_type, tuple(args), out_dir,
                                   threads),
                 nprocs=n, join=True)
        results = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
