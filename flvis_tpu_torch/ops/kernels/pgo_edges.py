"""pgo_edges: the pose graph's edge terms — each edge's residual
r = log(T_ij⁻¹ · (T_i exp ξ_i)⁻¹ · (T_j exp ξ_j)) at ξ = 0, its exact
Jacobians J_i, J_j (E, 6, 6) and its Cauchy weight, or its robust cost — for
every edge of a graph in one launch.

Replaces no TPU kernel: the JAX package leaves the linearisation to XLA,
which fuses its jax.vmap(jax.jacfwd(...)) (flvis_tpu/loop/pose_graph.py:71-75)
into a few device ops.  The plain twin is loop/pose_graph's own code, the
CPU path: `_edge_res_jac` (torch.func's vmap(jacfwd) over the edges) and the
cost over `_edge_residual`.  Eagerly on the card that twin dispatches ~3,000
aten ops a linearisation and ~340 a cost — tens of milliseconds of host time
a call whatever the graph's size, with the card idle — so both of
pose_graph's solvers (`_edge_terms`) take this kernel for a graph on the
card.

Two modes of one launch (csrc/pgo_edges.cu), on float32 CUDA tensors:
  linearize — (r (E, 6), J_i, J_j, J_i·w, J_j·w (E, 6, 6), w (E,)), w the
    Cauchy weight times edge_weight, zero on an invalid edge: what
    `_edge_terms`'s `weighted` returns;
  cost — (E,) ρ·edge_weight an edge, ρ = c² log1p(|r|²/c²), zero on an
    invalid edge; the caller sums it (torch.sum: a fixed order).
The kernel carries one tangent direction a thread through the same
formulas as geometry/se3 (forward mode, 12 threads an edge), so its
Jacobians are jacfwd's, small-angle and near-π branches included; it reads
nothing back to the host, uses no atomics and repeats bit for bit.  Bound:
one launch (an edge reads ~100 B and writes ≤ 0.6 KB).

`pgo_edges_kernel.launches` counts the kernel's launches, both modes.
"""

from __future__ import annotations

import torch

from . import _build

MODES = ("linearize", "cost")


def pgo_edges_kernel(node_q, node_t, edge_i, edge_j, edge_q, edge_t, edge_valid, edge_weight,
                     cauchy_c: float, *, mode: str):
    """Launch csrc/pgo_edges.cu: node_q (K, 4), node_t (K, 3), edge_q (E, 4),
    edge_t (E, 3), edge_weight (E,) contiguous float32; edge_i, edge_j (E,)
    int64 in [0, K); edge_valid (E,) bool; all on one CUDA device."""
    if mode not in MODES:
        raise ValueError(f"pgo_edges: mode must be one of {MODES}, got {mode!r}")
    _build.require_cuda_f32("pgo_edges", node_q=node_q, node_t=node_t, edge_q=edge_q,
                            edge_t=edge_t, edge_weight=edge_weight)
    K, E = node_q.shape[0], edge_i.shape[0] if edge_i.dim() == 1 else -1
    if (node_q.shape != (K, 4) or node_t.shape != (K, 3) or K < 1 or E < 1
            or edge_q.shape != (E, 4) or edge_t.shape != (E, 3)
            or edge_weight.shape != (E,) or edge_valid.shape != (E,)
            or edge_j.shape != (E,)):
        raise ValueError("pgo_edges: expected node_q (K, 4), node_t (K, 3), edge_i, edge_j, "
                         "edge_valid, edge_weight (E,), edge_q (E, 4), edge_t (E, 3) with "
                         f"K, E >= 1; got {tuple(node_q.shape)}, {tuple(node_t.shape)}, "
                         f"{tuple(edge_i.shape)}, {tuple(edge_q.shape)}")
    dev = node_t.device
    for name, t, dt in (("edge_i", edge_i, torch.int64), ("edge_j", edge_j, torch.int64),
                        ("edge_valid", edge_valid, torch.bool)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"pgo_edges: {name} must be a contiguous {dt} tensor on {dev}")
    f = dict(dtype=torch.float32, device=dev)
    if mode == "linearize":
        out = (torch.empty((E, 6), **f),) + tuple(torch.empty((E, 6, 6), **f)
                                                   for _ in range(4)) + (torch.empty(E, **f),)
        ptrs = [o.data_ptr() for o in out] + [None]
    else:
        out = torch.empty(E, **f)
        ptrs = [None] * 6 + [out.data_ptr()]
    lib, _ = _build.load_library()
    err = _build.launch_on(dev.index, lib.flvis_pgo_edges, node_q.data_ptr(), node_t.data_ptr(),
                           K, edge_i.data_ptr(), edge_j.data_ptr(), edge_q.data_ptr(),
                           edge_t.data_ptr(), edge_valid.data_ptr(), edge_weight.data_ptr(), E,
                           float(cauchy_c ** 2), MODES.index(mode), *ptrs,
                           _build.stream_of(node_t))
    _build.check_launch("pgo_edges", err)
    pgo_edges_kernel.launches += 1
    return out


pgo_edges_kernel.launches = 0


def pgo_edges(node_q, node_t, edge_i, edge_j, edge_q, edge_t, edge_valid, edge_weight,
              cauchy_c: float, *, mode: str):
    """CPU tensors take the plain twin (loop/pose_graph's vmap(jacfwd)
    linearisation and cost); CUDA tensors launch the kernel (which raises
    on what it cannot take)."""
    if node_t.is_cuda:
        return pgo_edges_kernel(node_q, node_t, edge_i, edge_j, edge_q, edge_t, edge_valid,
                                edge_weight, cauchy_c, mode=mode)
    if node_t.device.type == "cpu":
        from ...loop import pose_graph      # the twin's module imports this one
        return pose_graph.edge_terms_plain(node_q, node_t, edge_i, edge_j, edge_q, edge_t,
                                           edge_valid, edge_weight, cauchy_c, mode=mode)
    raise ValueError(f"pgo_edges: unsupported device {node_t.device}")
