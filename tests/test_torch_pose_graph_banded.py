"""The banded pose-graph solver of the port (loop/pose_graph.py:
`_thomas_solve`, `optimize_banded`) against the JAX package's, on the
graphs of tests/test_pose_graph.py, both packages starting from one numpy
graph (interop.to_pose_graph).

Tolerances: the Thomas solve 1e-4 (float32 LU solves of 96×96 blocks in
each framework); optimize_banded against the JAX one t 2e-4, q 2e-5 (the
Schur step's bounds of tests/test_window_ba.py:201-207, over 25 LM steps);
banded against the port's dense solve 2e-5 (tests/test_pose_graph.py:
162-171); the error-reduction and fixed-node bounds of that file."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.loop import pose_graph as jpg
from flvis_tpu_torch import interop
from flvis_tpu_torch.loop import pose_graph as tpg
from test_pose_graph import _reference_style_graph

torch.set_num_threads(1)


def _fixed(K):
    f = torch.zeros(K, dtype=torch.bool)
    f[0] = True
    return f


def _block_tridiagonal(G, S, N, seed=0):
    """A random SPD block-tridiagonal system: (D, U, X) and its dense B."""
    rng = np.random.default_rng(seed)
    B = np.zeros((G * S, G * S), np.float32)
    for g in range(G):
        a = rng.normal(size=(S, S)).astype(np.float32)
        B[g * S:(g + 1) * S, g * S:(g + 1) * S] = a @ a.T + S * np.eye(S, dtype=np.float32)
        if g + 1 < G:
            u = 0.3 * rng.normal(size=(S, S)).astype(np.float32)
            B[g * S:(g + 1) * S, (g + 1) * S:(g + 2) * S] = u
            B[(g + 1) * S:(g + 2) * S, g * S:(g + 1) * S] = u.T
    D = np.stack([B[g * S:(g + 1) * S, g * S:(g + 1) * S] for g in range(G)])
    U = np.stack([B[g * S:(g + 1) * S, (g + 1) * S:(g + 2) * S] if g + 1 < G
                  else np.zeros((S, S), np.float32) for g in range(G)])
    return D, U, rng.normal(size=(G, S, N)).astype(np.float32), B


def test_thomas_solve_matches():
    G, S, N = 4, 96, 9
    D, U, X, B = _block_tridiagonal(G, S, N)
    zj = np.asarray(jpg._thomas_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(X)))
    zt = tpg._thomas_solve(torch.as_tensor(D), torch.as_tensor(U), torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(zt, zj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(zt.reshape(-1, N), np.linalg.solve(B, X.reshape(-1, N)),
                               atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def k64():
    g, ts, ts_noisy, band_edges = _reference_style_graph(K=64, n=50)
    return g, interop.to_pose_graph(g, "cpu"), ts_noisy, band_edges


def test_optimize_banded_matches_jax(k64):
    g, tg, _, band_edges = k64
    gj, cj = jpg.optimize_banded(g, jnp.zeros(64, bool).at[0].set(True),
                                 band_edges=band_edges, iters=25)
    gt, ct = tpg.optimize_banded(tg, _fixed(64), band_edges=band_edges, iters=25)
    np.testing.assert_allclose(gt.node_t.numpy(), np.asarray(gj.node_t), atol=2e-4, rtol=0)
    np.testing.assert_allclose(gt.node_q.numpy(), np.asarray(gj.node_q), atol=2e-5, rtol=0)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3, atol=1e-6)


def test_banded_matches_dense(k64):
    _, tg, _, band_edges = k64
    gd, _ = tpg.optimize(tg, _fixed(64), iters=25)
    gb, _ = tpg.optimize_banded(tg, _fixed(64), band_edges=band_edges, iters=25)
    np.testing.assert_allclose(gb.node_t[:50].numpy(), gd.node_t[:50].numpy(), atol=2e-5)
    np.testing.assert_allclose(gb.node_q[:50].numpy(), gd.node_q[:50].numpy(), atol=2e-5)


def test_banded_fixed_node_unmoved(k64):
    _, tg, ts_noisy, band_edges = k64
    gb, _ = tpg.optimize_banded(tg, _fixed(64), band_edges=band_edges, iters=10)
    np.testing.assert_allclose(gb.node_t[0].numpy(), ts_noisy[0], atol=1e-6)


def test_banded_repeats_bit_for_bit(k64):
    """Fixed-order assembly: two calls on one graph give the same bits."""
    _, tg, _, band_edges = k64
    (g1, c1), (g2, c2) = (tpg.optimize_banded(tg, _fixed(64), band_edges=band_edges, iters=8)
                          for _ in range(2))
    assert torch.equal(g1.node_t, g2.node_t) and torch.equal(g1.node_q, g2.node_q)
    assert torch.equal(c1, c2)


def test_banded_reduces_error_large_graph():
    """A graph the dense path cannot reasonably take; loops pin widely
    separated nodes (tests/test_pose_graph.py:173-186)."""
    K, n = 512, 500
    g, ts, ts_noisy, band_edges = _reference_style_graph(
        K=K, n=n, loops=((0, 450), (10, 480), (200, 490)), noise=0.08)
    gb, _ = tpg.optimize_banded(interop.to_pose_graph(g, "cpu"), _fixed(K),
                                band_edges=band_edges, iters=15)
    err_before = np.linalg.norm(ts_noisy[:n] - ts[:n], axis=-1).max()
    err_after = np.linalg.norm(gb.node_t[:n].numpy() - ts[:n], axis=-1).max()
    assert err_after < 0.4 * err_before, (err_after, err_before)


def test_banded_refuses_unpadded_node_count(k64):
    _, tg, _, band_edges = k64
    import dataclasses

    cut = dataclasses.replace(tg, node_q=tg.node_q[:60], node_t=tg.node_t[:60],
                              node_valid=tg.node_valid[:60])
    with pytest.raises(AssertionError, match="multiple of _SUPER"):
        tpg.optimize_banded(cut, _fixed(60), band_edges=band_edges)
