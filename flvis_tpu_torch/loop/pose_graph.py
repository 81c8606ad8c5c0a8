"""Pose-graph optimisation on SE(3) — batched Levenberg-Marquardt (port of
flvis_tpu/loop/pose_graph.py).

Nodes are world-from-camera poses T_w_c; edge residual
r = log(T_ij⁻¹ · (T_i exp ξ_i)⁻¹ · (T_j exp ξ_j)) with exact Jacobians from
forward-mode autodiff (torch.func.jacfwd, vmapped over the edges) and
Cauchy weights.  Two solvers share one LM loop (`_lm_outer_loop`, the
reference's `while_loop` with its accept/λ/exit semantics and a host read
per iteration):
  - `optimize`: one dense solve of the (6K, 6K) normal system per LM step;
  - `optimize_banded`: the block-tridiagonal + Woodbury solver for
    thousands of nodes — super-nodes of `_SUPER` poses make the sequential
    band block-tridiagonal, a Thomas pass (`_thomas_solve`) solves it
    against [b, U_w], and the loop edges enter as a rank-6L Woodbury
    correction.
Both assemble their normal systems in a fixed order with no float atomics
(`_sum_plan`, built once per call), so a graph optimised twice on the card
gives the same bits.  The Thomas steps and the Woodbury solve use
`torch.linalg.solve_ex`, which reads no error flag back to the host.  Both
return a `Solved`: (graph, cost), with the LM loop's iterations and
rejected steps by name; the loop's host reads go through
utils/profiling.host_read.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd, vmap

from ..geometry import se3 as se3m, so3
from ..geometry.se3 import SE3
from ..utils import profiling


class Solved(tuple):
    """What optimize and optimize_banded return: the pair (graph, final
    cost), with the LM loop's counts `lm_iters` (solves) and `lm_rejects`
    (rejected steps) as attributes beside it, as os.stat_result keeps fields
    past its tuple."""

    def __new__(cls, graph, cost, lm_iters: int, lm_rejects: int):
        self = super().__new__(cls, (graph, cost))
        self.lm_iters, self.lm_rejects = lm_iters, lm_rejects
        return self


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


def _sum_plan(keys, width: int | None = None):
    """A fixed-order plan for summing rows that share a key: the rows'
    positions, grouped by key in a stable sort, padded to `width` (the
    largest group when None: one host read) with the index len(keys), a
    zero row the caller appends.  Returns (table (n, width) int64,
    group_key (n,) int64): group g sums the rows table[g] and lands at
    group_key[g]; the groups past the last key hold only padding and land
    at key -1, which the caller sends to a dump row."""
    n = keys.shape[0]
    sk, order = torch.sort(keys, stable=True)
    new = torch.ones(n, dtype=torch.bool, device=keys.device)
    new[1:] = sk[1:] != sk[:-1]
    gid = torch.cumsum(new.to(torch.int64), 0) - 1
    ar = torch.arange(n, device=keys.device)
    pos = ar - torch.cummax(torch.where(new, ar, 0), 0).values
    if width is None:
        width = int(profiling.host_read(torch.max(pos), site="pgo.plan_width")) + 1
    table = torch.full((n, width), n, dtype=torch.int64, device=keys.device)
    table[gid, pos] = order
    group_key = torch.full((n,), -1, dtype=torch.int64, device=keys.device)
    group_key[gid] = sk                  # every write within a group is the same key
    return table, group_key


def _assembly_plan(ii, jj, K: int):
    """The plans for H's 4E (row, column) blocks [(i,i), (j,j), (i,j), (j,i)]
    and b's 2E rows [i, j], with one host read for their common width: a
    node's diagonal block gathers at least as many terms as its b row."""
    h_plan = _sum_plan(torch.cat([ii * K + ii, jj * K + jj, ii * K + jj, jj * K + ii]))
    return h_plan, _sum_plan(torch.cat([ii, jj]), h_plan[0].shape[1])


def _plan_sum(plan, rows, n_out: int):
    """Sum `rows` (n, ...) by the plan into (n_out, ...) in the plan's fixed
    order; outputs no key reaches are zero."""
    table, group_key = plan
    padded = torch.cat([rows, torch.zeros_like(rows[:1])])
    sums = padded[table].sum(dim=1)
    out = torch.zeros((n_out + 1,) + rows.shape[1:], dtype=rows.dtype, device=rows.device)
    out[torch.where(group_key < 0, n_out, group_key)] = sums   # padding groups: zeros, dump row
    return out[:n_out]


def _edge_terms(graph: PoseGraph, cauchy_c: float):
    """The two functions of the nodes both solvers share: the robust total
    cost, and the linearisation (r, J_i, J_j, J_i·w, J_j·w, w) with the
    Cauchy weights (zero on invalid edges)."""
    ii, jj = graph.edge_i.long(), graph.edge_j.long()
    Tij = SE3(graph.edge_q, graph.edge_t)
    dev, dt = graph.node_t.device, graph.node_t.dtype

    def total_cost(nodes: SE3):
        Ti, Tj = _index(nodes, ii), _index(nodes, jj)
        z = torch.zeros((ii.shape[0], 6), dtype=dt, device=dev)
        r = _edge_residual(z, z, Ti.q, Ti.t, Tj.q, Tj.t, Tij.q, Tij.t)
        r2 = torch.sum(r * r, dim=-1)
        rho = (cauchy_c ** 2) * torch.log1p(r2 / cauchy_c ** 2)
        return torch.sum(torch.where(graph.edge_valid, rho * graph.edge_weight, 0.0))

    def weighted(nodes: SE3):
        r, Ji, Jj = _edge_res_jac(_index(nodes, ii), _index(nodes, jj), Tij)
        r2 = torch.sum(r * r, dim=-1)
        w = _cauchy_weight(r2, cauchy_c) * graph.edge_weight
        w = torch.where(graph.edge_valid, w, 0.0)
        return r, Ji, Jj, Ji * w[:, None, None], Jj * w[:, None, None], w

    return total_cost, weighted


def _gradient(b_plan, r, JiW, JjW, K: int):
    """−Jᵀ W r summed per node by the plan: (K, 6)."""
    return _plan_sum(b_plan, torch.cat([-torch.einsum("eki,ek->ei", JiW, r),
                                        -torch.einsum("eki,ek->ei", JjW, r)]), K)


def optimize(graph: PoseGraph, fixed_mask, iters: int = 20, cauchy_c: float = 1.0,
             lam0: float = 1e-4):
    """LM on the pose graph; fixed_mask (K,) holds nodes constant.  Returns
    a Solved: (updated graph, final cost) and the LM loop's counts."""
    K = graph.num_nodes
    fix = torch.repeat_interleave(fixed_mask | ~graph.node_valid, 6)
    h_plan, b_plan = _assembly_plan(graph.edge_i.long(), graph.edge_j.long(), K)
    total_cost, weighted = _edge_terms(graph, cauchy_c)

    def linearize(nodes: SE3):
        r, Ji, Jj, JiW, JjW, _ = weighted(nodes)
        blocks = torch.cat([torch.einsum("eki,ekj->eij", JiW, Ji),
                            torch.einsum("eki,ekj->eij", JjW, Jj),
                            torch.einsum("eki,ekj->eij", JiW, Jj),
                            torch.einsum("eki,ekj->eij", JjW, Ji)])
        H = _plan_sum(h_plan, blocks, K * K).reshape(K, K, 6, 6)
        b = _gradient(b_plan, r, JiW, JjW, K)
        Hd = H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        Hd = torch.where(fix[:, None] | fix[None, :], 0.0, Hd)
        return Hd, torch.diagonal(Hd), torch.where(fix, 0.0, b.reshape(-1))

    def solve(nodes: SE3, lin, lam):
        Hd, diag, bv = lin
        Hd = Hd + torch.diag(torch.where(fix, 1.0, lam * torch.clamp(diag, min=1e-6) + 1e-9))
        with profiling.host_sync("pgo.solve_check"):       # linalg.solve reads its error flag
            dx = torch.linalg.solve(Hd, bv).reshape(K, 6)
        return se3m.compose(nodes, se3m.exp(dx)), torch.max(torch.abs(dx))

    nodes, cost, n_iter, n_rej = _lm_outer_loop(linearize, solve, total_cost,
                                                SE3(graph.node_q, graph.node_t), lam0, iters)
    return Solved(dataclasses.replace(graph, node_q=nodes.q, node_t=nodes.t), cost,
                  n_iter, n_rej)


def _lm_outer_loop(linearize, solve, total_cost, nodes0: SE3, lam0: float, iters: int):
    """The reference's LM accept/reject loop (pose_graph.py:142-210): exit on
    an accepted step that improves the cost by < 1e-4 relative or moves
    < 5e-3, or after 2 consecutive rejections once a step was accepted (or
    λ reached its 1e4 cap); a rejected step re-damps the stored system.
    λ stays a float32 tensor so its products round as the reference's.
    Returns (nodes, cost, iterations, rejected steps)."""
    dev = nodes0.t.device

    def read(t) -> bool:
        return bool(profiling.host_read(t, site="pgo.lm"))

    nodes, lin = nodes0, linearize(nodes0)
    with profiling.host_sync("pgo.lambda"):         # an upload from pageable host memory
        lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    cost = total_cost(nodes0)
    rej, acc_any = 0, False
    n_iter = n_rej = 0
    for it in range(iters):
        new_nodes, dx_inf = solve(nodes, lin, lam)
        new_cost = total_cost(new_nodes)
        n_iter += 1
        better = read(new_cost < cost)
        if better:
            done = read(cost - new_cost < 1e-4 * cost) or read(dx_inf < 5e-3)
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
            n_rej += 1
            if rej >= 2 and (acc_any or read(lam >= 1e4)):
                break
    return nodes, cost, n_iter, n_rej


# ---------------------------------------------------------------------------
# The scalable solver: block-tridiagonal (super-node) elimination + Woodbury
# (the reference's pose_graph.py:213-394).  Grouping _SUPER consecutive poses
# into one 6·_SUPER-dof super-node makes every band edge (span ≤ _SUPER)
# couple a super-node with itself or its successor, so the band part B of
# the normal matrix is block-tridiagonal; loop edges enter as
#     H = B + U Uᵀ,   H⁻¹b = B⁻¹b − B⁻¹U (I + UᵀB⁻¹U)⁻¹ UᵀB⁻¹b.
# ---------------------------------------------------------------------------

_SUPER = 16


def _thomas_solve(D, U, X):
    """Solve the symmetric block-tridiagonal system B · x = X, where
    B[g,g] = D[g], B[g,g+1] = U[g], B[g+1,g] = U[g]ᵀ.  D, U: (G, S, S) (U's
    last row ignored), X: (G, S, N) → (G, S, N).  Forward elimination and
    back-substitution are G − 1 steps each; each forward step is one LU
    solve shared by all N right-hand sides."""
    S = D.shape[1]
    G = D.shape[0]
    Dt, Xg = D[0], X[0]
    Cs, Ys = [], []
    for g in range(G - 1):
        sol = torch.linalg.solve_ex(Dt, torch.cat([U[g], Xg], dim=1))[0]
        C_g, Y_g = sol[:, :S], sol[:, S:]
        Ut = U[g].T
        Dt = D[g + 1] - Ut @ C_g
        Xg = X[g + 1] - Ut @ Y_g
        Cs.append(C_g)
        Ys.append(Y_g)
    sol = torch.linalg.solve_ex(Dt, Xg)[0]
    out = [sol]
    for g in range(G - 2, -1, -1):
        sol = Ys[g] - Cs[g] @ sol
        out.append(sol)
    return torch.stack(out[::-1])


def _band_plan(ii, jj, Eb: int, K: int):
    """The fixed-order plan of the band's 4·Eb 6×6 blocks [H_ii, H_jj, H_ij,
    H_ijᵀ] into the block slots of D (G·s·s of them) then U (as many):
    a block at super-node g, local rows a, columns c has slot (g·s + a)·s +
    c; an H_ij that crosses into the next super-node goes to U, and its
    transpose (D's only when the edge stays inside one super-node) to no
    slot."""
    s = _SUPER
    gi, li = ii[:Eb] // s, ii[:Eb] % s
    gj, lj = jj[:Eb] // s, jj[:Eb] % s
    same = gi == gj
    n_slots = K * s

    def slot(g, a, c):
        return (g * s + a) * s + c

    keys = torch.cat([slot(gi, li, li), slot(gj, lj, lj),
                      torch.where(same, slot(gi, li, lj), n_slots + slot(gi, li, lj)),
                      torch.where(same, slot(gi, lj, li), 2 * n_slots)])
    return _sum_plan(keys)


def optimize_banded(graph: PoseGraph, fixed_mask, band_edges: int, iters: int = 20,
                    cauchy_c: float = 1.0, lam0: float = 1e-4):
    """LM on the pose graph with the block-tridiagonal + Woodbury solver:
    `optimize`'s semantics, scalable to thousands of nodes.  Edges
    [0:band_edges] are band edges with edge_i ≤ edge_j ≤ edge_i + _SUPER;
    edges [band_edges:] are loop edges between any pair (Woodbury columns:
    keep the bucket small).  num_nodes must be a multiple of _SUPER.
    Returns a Solved, as optimize does."""
    K = graph.num_nodes
    s = _SUPER
    assert K % s == 0, "pad node count to a multiple of _SUPER"
    G, S = K // s, 6 * s
    Eb = band_edges
    Lp = graph.edge_i.shape[0] - Eb
    dev, dt = graph.node_t.device, graph.node_t.dtype
    ii, jj = graph.edge_i.long(), graph.edge_j.long()
    held = fixed_mask | ~graph.node_valid                          # (K,)
    keep_node = (~held).to(dt)
    n_slots = K * s
    d_plan = _band_plan(ii, jj, Eb, K)
    b_plan = _sum_plan(torch.cat([ii, jj]))
    eidx = torch.arange(Lp, device=dev)
    li, lj = ii[Eb:], jj[Eb:]
    fix = held.repeat_interleave(6).reshape(G, S).to(dt)          # (G, S)
    keep = 1.0 - fix
    keep_next = torch.cat([keep[1:], torch.ones((1, S), dtype=dt, device=dev)])
    total_cost, weighted = _edge_terms(graph, cauchy_c)

    def blocks_to(flat, n):
        """(n·s·s, 6, 6) block slots → (n, S, S) matrices."""
        return flat.reshape(n, s, s, 6, 6).permute(0, 1, 3, 2, 4).reshape(n, S, S)

    def linearize(nodes: SE3):
        r, Ji, Jj, JiW, JjW, w = weighted(nodes)
        b = _gradient(b_plan, r, JiW, JjW, K)                     # loop edges too
        # The band's blocks into D and U.
        Hij = torch.einsum("eki,ekj->eij", JiW[:Eb], Jj[:Eb])
        blocks = torch.cat([torch.einsum("eki,ekj->eij", JiW[:Eb], Ji[:Eb]),
                            torch.einsum("eki,ekj->eij", JjW[:Eb], Jj[:Eb]),
                            Hij, Hij.transpose(-1, -2)])
        DU = _plan_sum(d_plan, blocks, 2 * n_slots)
        D, U = blocks_to(DU[:n_slots], G), blocks_to(DU[n_slots:], G)
        # The loop edges' Woodbury columns, rank 6 each: U_w[node, dof, e, k].
        sqw = torch.sqrt(w[Eb:])
        Ui_col = Ji[Eb:].transpose(-1, -2) * sqw[:, None, None]
        Uj_col = Jj[Eb:].transpose(-1, -2) * sqw[:, None, None]
        Uw = torch.zeros((K, 6, Lp, 6), dtype=dt, device=dev)
        Uw[li, :, eidx, :] = Ui_col
        Uw[lj, :, eidx, :] = Uw[lj, :, eidx, :] + Uj_col
        # The damping base from the full diagonal, band and loop; λ scales it
        # in solve(), so a rejected step re-damps without re-assembling.
        d_band = torch.diagonal(D, dim1=1, dim2=2).reshape(K, 6)
        d_loop = torch.sum(Uw * Uw, dim=(2, 3))
        damp_base = torch.where(held[:, None], 0.0, torch.clamp(d_band + d_loop, min=1e-6))
        # Held nodes: identity rows and columns.
        D = D * keep[:, :, None] * keep[:, None, :] + torch.diag_embed(fix)
        U = U * keep[:, :, None] * keep_next[:, None, :]
        bv = b * keep_node[:, None]
        Uw = Uw * keep_node[:, None, None, None]
        return D, U, Uw, bv, damp_base

    def solve(nodes: SE3, lin, lam):
        D, U, Uw, bv, damp_base = lin
        damp = lam * damp_base + torch.where(damp_base > 0.0, 1e-9, 0.0)
        D = D + torch.diag_embed(damp.reshape(G, S))
        X = torch.cat([bv.reshape(K, 6, 1), Uw.reshape(K, 6, Lp * 6)], dim=-1)
        Z = _thomas_solve(D, U, X.reshape(G, S, 1 + 6 * Lp)).reshape(K * 6, 1 + 6 * Lp)
        z_b, Z_u = Z[:, 0], Z[:, 1:]
        Uf = Uw.reshape(K * 6, Lp * 6)
        M = torch.eye(Lp * 6, dtype=dt, device=dev) + Uf.T @ Z_u
        y = torch.linalg.solve_ex(M, (Uf.T @ z_b)[:, None])[0][:, 0]
        dx = (z_b - Z_u @ y).reshape(K, 6)
        dx = torch.where(held[:, None], 0.0, dx)
        return se3m.compose(nodes, se3m.exp(dx)), torch.max(torch.abs(dx))

    nodes, cost, n_iter, n_rej = _lm_outer_loop(linearize, solve, total_cost,
                                                SE3(graph.node_q, graph.node_t), lam0, iters)
    return Solved(dataclasses.replace(graph, node_q=nodes.q, node_t=nodes.t), cost,
                  n_iter, n_rej)
