"""Pose-graph optimisation on SE(3) — batched Levenberg-Marquardt over a
dense normal system (port of the dense path of flvis_tpu/loop/pose_graph.py).

Nodes are world-from-camera poses T_w_c; edge residual
r = log(T_ij⁻¹ · (T_i exp ξ_i)⁻¹ · (T_j exp ξ_j)) with exact Jacobians from
forward-mode autodiff (torch.func.jacfwd, vmapped over the edges), Cauchy
weights, and one dense solve per LM step.  The LM loop's `while_loop`
keeps its accept/λ/exit semantics with one host read per iteration.  The
block-tridiagonal + Woodbury solver (`optimize_banded`, used past 256
nodes) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd, vmap

from ..geometry import se3 as se3m, so3
from ..geometry.se3 import SE3


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    node_q: torch.Tensor      # (K, 4)
    node_t: torch.Tensor      # (K, 3)
    node_valid: torch.Tensor  # (K,) bool
    edge_i: torch.Tensor      # (E,) int source node
    edge_j: torch.Tensor      # (E,) int target node
    edge_q: torch.Tensor      # (E, 4) measured T_i_j = T_wi⁻¹ T_wj
    edge_t: torch.Tensor      # (E, 3)
    edge_valid: torch.Tensor  # (E,) bool
    edge_weight: torch.Tensor  # (E,) information scale

    @property
    def num_nodes(self):
        return self.node_q.shape[0]


def empty(max_nodes: int, max_edges: int, *, device, dtype=torch.float32) -> PoseGraph:
    return PoseGraph(
        node_q=so3.identity((max_nodes,), dtype, device),
        node_t=torch.zeros((max_nodes, 3), dtype=dtype, device=device),
        node_valid=torch.zeros(max_nodes, dtype=torch.bool, device=device),
        edge_i=torch.zeros(max_edges, dtype=torch.int64, device=device),
        edge_j=torch.zeros(max_edges, dtype=torch.int64, device=device),
        edge_q=so3.identity((max_edges,), dtype, device),
        edge_t=torch.zeros((max_edges, 3), dtype=dtype, device=device),
        edge_valid=torch.zeros(max_edges, dtype=torch.bool, device=device),
        edge_weight=torch.ones(max_edges, dtype=dtype, device=device))


def _edge_residual(xi_i, xi_j, qi, ti, qj, tj, qij, tij):
    """r = log(Tij⁻¹ · (Ti·exp(ξi))⁻¹ · (Tj·exp(ξj))) for one edge."""
    Ti_p = se3m.compose(SE3(qi, ti), se3m.exp(xi_i))
    Tj_p = se3m.compose(SE3(qj, tj), se3m.exp(xi_j))
    rel = se3m.compose(se3m.inverse(Ti_p), Tj_p)
    return se3m.log(se3m.compose(se3m.inverse(SE3(qij, tij)), rel))


_jac = vmap(jacfwd(_edge_residual, argnums=(0, 1)))


def _edge_res_jac(Ti: SE3, Tj: SE3, Tij: SE3):
    """Residuals (E, 6) and Jacobians (E, 6, 6) × 2 at ξ = 0."""
    z = torch.zeros(Ti.t.shape[:-1] + (6,), dtype=Ti.t.dtype, device=Ti.t.device)
    args = (z, z, Ti.q, Ti.t, Tj.q, Tj.t, Tij.q, Tij.t)
    Ji, Jj = _jac(*args)
    return _edge_residual(*args), Ji, Jj


def _cauchy_weight(r2, c: float):
    return 1.0 / (1.0 + r2 / (c * c))


def _index(T: SE3, idx) -> SE3:
    return SE3(T.q[idx], T.t[idx])


def optimize(graph: PoseGraph, fixed_mask, iters: int = 20, cauchy_c: float = 1.0,
             lam0: float = 1e-4):
    """LM on the pose graph; fixed_mask (K,) holds nodes constant.  Returns
    (updated graph, final cost)."""
    K = graph.num_nodes
    dev, dt = graph.node_t.device, graph.node_t.dtype
    ii, jj = graph.edge_i.long(), graph.edge_j.long()
    Tij = SE3(graph.edge_q, graph.edge_t)
    fix = torch.repeat_interleave(fixed_mask | ~graph.node_valid, 6)

    def total_cost(nodes: SE3):
        Ti, Tj = _index(nodes, ii), _index(nodes, jj)
        z = torch.zeros((ii.shape[0], 6), dtype=dt, device=dev)
        r = _edge_residual(z, z, Ti.q, Ti.t, Tj.q, Tj.t, Tij.q, Tij.t)
        r2 = torch.sum(r * r, dim=-1)
        rho = (cauchy_c ** 2) * torch.log1p(r2 / cauchy_c ** 2)
        return torch.sum(torch.where(graph.edge_valid, rho * graph.edge_weight, 0.0))

    def linearize(nodes: SE3):
        r, Ji, Jj = _edge_res_jac(_index(nodes, ii), _index(nodes, jj), Tij)
        r2 = torch.sum(r * r, dim=-1)
        w = _cauchy_weight(r2, cauchy_c) * graph.edge_weight
        w = torch.where(graph.edge_valid, w, 0.0)
        JiW, JjW = Ji * w[:, None, None], Jj * w[:, None, None]
        H = torch.zeros((K, K, 6, 6), dtype=dt, device=dev)
        H.index_put_((ii, ii), torch.einsum("eki,ekj->eij", JiW, Ji), accumulate=True)
        H.index_put_((jj, jj), torch.einsum("eki,ekj->eij", JjW, Jj), accumulate=True)
        H.index_put_((ii, jj), torch.einsum("eki,ekj->eij", JiW, Jj), accumulate=True)
        H.index_put_((jj, ii), torch.einsum("eki,ekj->eij", JjW, Ji), accumulate=True)
        b = torch.zeros((K, 6), dtype=dt, device=dev)
        b.index_add_(0, ii, -torch.einsum("eki,ek->ei", JiW, r))
        b.index_add_(0, jj, -torch.einsum("eki,ek->ei", JjW, r))
        Hd = H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        Hd = torch.where(fix[:, None] | fix[None, :], 0.0, Hd)
        return Hd, torch.diagonal(Hd), torch.where(fix, 0.0, b.reshape(-1))

    def solve(nodes: SE3, lin, lam):
        Hd, diag, bv = lin
        Hd = Hd + torch.diag(torch.where(fix, 1.0, lam * torch.clamp(diag, min=1e-6) + 1e-9))
        dx = torch.linalg.solve(Hd, bv).reshape(K, 6)
        return se3m.compose(nodes, se3m.exp(dx)), torch.max(torch.abs(dx))

    nodes, cost = _lm_outer_loop(linearize, solve, total_cost,
                                 SE3(graph.node_q, graph.node_t), lam0, iters)
    return dataclasses.replace(graph, node_q=nodes.q, node_t=nodes.t), cost


def _lm_outer_loop(linearize, solve, total_cost, nodes0: SE3, lam0: float, iters: int):
    """The reference's LM accept/reject loop (pose_graph.py:142-210): exit on
    an accepted step that improves the cost by < 1e-4 relative or moves
    < 5e-3, or after 2 consecutive rejections once a step was accepted (or
    λ reached its 1e4 cap); a rejected step re-damps the stored system.
    λ stays a float32 tensor so its products round as the reference's."""
    dev = nodes0.t.device
    nodes, lin = nodes0, linearize(nodes0)
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    cost = total_cost(nodes0)
    rej, acc_any = 0, False
    for it in range(iters):
        new_nodes, dx_inf = solve(nodes, lin, lam)
        new_cost = total_cost(new_nodes)
        better = bool(new_cost < cost)
        if better:
            done = (bool(cost - new_cost < 1e-4 * cost) or bool(dx_inf < 5e-3))
            nodes, cost = new_nodes, new_cost
            lam = torch.clamp(lam * 0.3, min=1e-8)
            rej, acc_any = 0, True
            if done:
                break
            if it + 1 < iters:
                lin = linearize(nodes)
        else:
            lam = torch.clamp(lam * 6.0, max=1e4)
            rej += 1
            if rej >= 2 and (acc_any or bool(lam >= 1e4)):
                break
    return nodes, cost
