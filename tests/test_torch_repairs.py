"""Two repairs of the port, on the CPU:

  - the window BA's Schur route (`window_ba._use_schur_kernel`): the CUDA
    kernel only on a CUDA device, with `pallas_schur` set and a window of at
    most schur.MAX_WINDOW poses, else the plain step; a 20-keyframe window
    through the port's optimize against the JAX package's, within the
    Schur step's bounds (tests/test_window_ba.py:201-207);
  - PGO's normal-system assembly in a fixed order (`pose_graph._sum_plan`)
    against the scatter-add form it replaces, within 1e-6 relative, on
    random graphs with repeated loop edges on one pair, and the dense PGO
    of such a graph against the JAX package's."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flvis_tpu.config as jconfig
import flvis_tpu_torch.config as tconfig
from flvis_tpu.backend import window_ba as jwba
from flvis_tpu.geometry import so3 as jso3
from flvis_tpu.loop import pose_graph as jpg
from flvis_tpu_torch import interop
from flvis_tpu_torch.backend import window_ba as twba
from flvis_tpu_torch.loop import pose_graph as tpg
from flvis_tpu_torch.ops.kernels import schur
from test_torch_window_ba import JCAM, TCAM, TO_T, _packet

torch.set_num_threads(1)
WIDE = dict(window_size=20, max_landmarks=128, min_views=3, iters1=12, iters2=8)
STEP_TOL = {"t": 2e-4, "q": 2e-5, "lm": 2e-3}


@pytest.mark.parametrize("W", [10, 16, 17, 20])
@pytest.mark.parametrize("pallas_schur", [True, False])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_use_schur_kernel_truth_table(device, pallas_schur, W):
    cfg = tconfig.BackendConfig(window_size=W, pallas_schur=pallas_schur)
    want = device == "cuda" and pallas_schur and W <= schur.MAX_WINDOW
    assert twba._use_schur_kernel(cfg, torch.device(device)) is want
    assert twba._use_schur_kernel(cfg, device) is want


def _wide_windows(seed, noise, pose_noise, pw_noise, n_kf=20):
    """A window of n_kf keyframes over 60 landmarks, built by both packages'
    add_keyframe from the packets of tests/test_torch_window_ba.py."""
    jcfg, tcfg = jconfig.BackendConfig(**WIDE), tconfig.BackendConfig(**WIDE)
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -3, 6], [4, 3, 14], size=(60, 3)).astype(np.float32)
    js, ts = jwba.empty(jcfg), twba.empty(tcfg, device="cpu")
    like = twba.KeyframePacket(*([None] * 9))
    for i in range(n_kf):
        p = _packet(i, pts, rng, noise, 0.0 if i == 0 else pose_noise, pw_noise)
        js = jwba.add_keyframe(jcfg, js, p)
        ts = twba.add_keyframe(tcfg, ts, interop.from_numpy(interop.to_numpy(p), like, TO_T))
    return jcfg, tcfg, js, ts


@pytest.fixture(scope="module")
def wide_runs():
    """Both packages' optimize on two 20-keyframe windows; the JAX side
    compiles once for both (same config, same shapes)."""
    out = {}
    for case, kw in (("noisy_init", dict(seed=2, noise=0.0, pose_noise=0.02, pw_noise=0.1)),
                     ("noisy_obs", dict(seed=3, noise=0.3, pose_noise=0.01, pw_noise=0.05))):
        jcfg, tcfg, js, ts = _wide_windows(**kw)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            tr = twba.optimize(tcfg, TCAM, ts)
        out[case] = (interop.to_numpy(jwba.optimize(jcfg, JCAM, js)), interop.to_numpy(tr),
                     [w for w in rec if issubclass(w.category, RuntimeWarning)])
    return out


@pytest.mark.parametrize("case", ["noisy_init", "noisy_obs"])
def test_optimize_wide_window_matches_jax(wide_runs, case):
    """window_size=20 runs the plain step on the CPU, silently, and its
    two-phase optimize agrees with the reference's XLA step."""
    jd, td, warned = wide_runs[case]
    assert not warned
    for k in ("kf_frame_id", "kf_valid", "lm_id", "lm_valid", "obs_valid"):
        np.testing.assert_array_equal(td["state"][k], jd["state"][k], err_msg=k)
    np.testing.assert_allclose(td["state"]["kf_t"], jd["state"]["kf_t"], atol=STEP_TOL["t"],
                               rtol=0)
    np.testing.assert_allclose(td["state"]["kf_q"], jd["state"]["kf_q"], atol=STEP_TOL["q"],
                               rtol=0)
    live = jd["state"]["lm_valid"]
    np.testing.assert_allclose(td["state"]["lm_pw"][live], jd["state"]["lm_pw"][live],
                               atol=STEP_TOL["lm"], rtol=0)
    assert int(td["num_obs"]) == int(jd["num_obs"])
    assert bool(td["correction"]["valid"])


def test_pallas_schur_false_is_the_plain_route_on_cpu():
    """pallas_schur=False gives the default's bits on the CPU, where both
    take the plain step, and launches nothing."""
    _, tcfg, _, ts = _wide_windows(seed=5, noise=0.2, pose_noise=0.01, pw_noise=0.05, n_kf=6)
    off = tconfig.BackendConfig(**{**WIDE, "pallas_schur": False})
    before = schur.schur_step_kernel.launches
    a, b = twba.optimize(tcfg, TCAM, ts), twba.optimize(off, TCAM, ts)
    assert schur.schur_step_kernel.launches == before
    assert torch.equal(a.state.kf_t, b.state.kf_t) and torch.equal(a.state.lm_pw, b.state.lm_pw)


def _random_graph(seed, K=24, n_loop=6, repeats=3):
    """A chain of K nodes with successor edges 1..2 apart and loop edges,
    one pair repeated `repeats` times."""
    rng = np.random.default_rng(seed)
    seq = [(i, i + s) for s in (1, 2) for i in range(K - s)]
    loops = [tuple(sorted(rng.choice(K, 2, replace=False))) for _ in range(n_loop)]
    loops += [loops[0]] * repeats
    ii, jj = (np.asarray(v, np.int64) for v in zip(*(seq + loops)))
    return ii, jj, rng


def _scatter_assembly(ii, jj, K, blocks, brows):
    """The assembly the fixed-order plan replaces: index_put_(accumulate)
    and index_add_ over the stacked per-edge blocks."""
    E = ii.shape[0]
    H = torch.zeros((K, K, 6, 6), dtype=blocks.dtype)
    for n, (a, b) in enumerate(((ii, ii), (jj, jj), (ii, jj), (jj, ii))):
        H.index_put_((a, b), blocks[n * E:(n + 1) * E], accumulate=True)
    bv = torch.zeros((K, 6), dtype=brows.dtype)
    bv.index_add_(0, ii, brows[:E])
    bv.index_add_(0, jj, brows[E:])
    return H, bv


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pgo_fixed_order_assembly_matches_scatter_add(seed):
    ii, jj, rng = _random_graph(seed)
    K = 24
    ti, tj = torch.as_tensor(ii), torch.as_tensor(jj)
    E = ii.shape[0]
    blocks = torch.as_tensor(rng.normal(0, 1, (4 * E, 6, 6)), dtype=torch.float32)
    brows = torch.as_tensor(rng.normal(0, 1, (2 * E, 6)), dtype=torch.float32)
    h_plan, b_plan = tpg._assembly_plan(ti, tj, K)
    H = tpg._plan_sum(h_plan, blocks, K * K).reshape(K, K, 6, 6)
    b = tpg._plan_sum(b_plan, brows, K)
    H_ref, b_ref = _scatter_assembly(ti, tj, K, blocks, brows)
    scale = float(H_ref.abs().max())
    assert float((H - H_ref).abs().max()) <= 1e-6 * scale
    assert float((b - b_ref).abs().max()) <= 1e-6 * float(b_ref.abs().max())
    # The repeated loop pair gathers all its terms into one block.
    i0, j0 = int(ii[-1]), int(jj[-1])
    assert float(H[i0, j0].abs().max()) > 0.0
    # Blocks no edge reaches stay exactly zero.
    reached = torch.zeros((K, K), dtype=torch.bool)
    reached[ti, tj] = reached[tj, ti] = reached[ti, ti] = reached[tj, tj] = True
    assert not bool(H[~reached].any())


def _graph_pair(seed, K=40):
    """The same drifted chain + repeated loop edges as a JAX and a port
    PoseGraph (the reference's dense path)."""
    ii, jj, rng = _random_graph(seed, K=K, n_loop=4, repeats=2)
    E = ii.shape[0]
    gt_t = np.stack([-0.1 * np.arange(K), np.zeros(K), np.zeros(K)], -1).astype(np.float32)
    drift = np.stack([np.zeros(K), 0.01 * np.arange(K), np.zeros(K)], -1).astype(np.float32)
    node_t = gt_t + drift
    node_q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (K, 1))
    dq = jso3.exp(jnp.asarray(rng.normal(0, 0.002, (E, 3)), jnp.float32))
    edge_t = (gt_t[jj] - gt_t[ii] + rng.normal(0, 0.002, (E, 3))).astype(np.float32)
    edge_q = np.array(dq)
    w = np.ones(E, np.float32)
    valid = np.ones(E, bool)
    jg = jpg.PoseGraph(jnp.asarray(node_q), jnp.asarray(node_t), jnp.ones(K, bool),
                       jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32),
                       jnp.asarray(edge_q), jnp.asarray(edge_t), jnp.asarray(valid),
                       jnp.asarray(w))
    tg = tpg.PoseGraph(torch.as_tensor(node_q), torch.as_tensor(node_t),
                       torch.ones(K, dtype=torch.bool), torch.as_tensor(ii),
                       torch.as_tensor(jj), torch.as_tensor(edge_q), torch.as_tensor(edge_t),
                       torch.as_tensor(valid), torch.as_tensor(w))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return jg, tg, fixed


@pytest.mark.parametrize("seed", [0, 1])
def test_pgo_with_repeated_loop_edges_matches_jax(seed):
    """Dense PGO through the fixed-order assembly against the reference's,
    node poses within 1e-4 (the bound of tests/test_torch_loop.py)."""
    jg, tg, fixed = _graph_pair(seed)
    jout, _ = jpg.optimize(jg, jnp.asarray(fixed), iters=20)
    tout, _ = tpg.optimize(tg, torch.as_tensor(fixed), iters=20)
    np.testing.assert_allclose(tout.node_t.numpy(), np.asarray(jout.node_t), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tout.node_q.numpy(), np.asarray(jout.node_q), atol=1e-4, rtol=0)
    again, _ = tpg.optimize(tg, torch.as_tensor(fixed), iters=20)
    assert torch.equal(again.node_t, tout.node_t) and torch.equal(again.node_q, tout.node_q)
