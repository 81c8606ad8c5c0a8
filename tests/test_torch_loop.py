"""loop/bow, loop/pose_graph and loop/loop_closing of the port against the
JAX package.

The reference's random draws are handed to the port at the two points
where it draws: `bow.train`'s initial centroids (jax.random.choice) and the
verification's PnP RANSAC scores (jax.random.uniform under
PRNGKey(i·7919 + j)).  Tolerances:
  - BoW: centroids identical (sums of ±1 are exact), idf, tf-idf rows and
    scores within 1e-6 (float32 log and sum order);
  - dense PGO on the injected-drift scenes of tests/test_loop_closing.py:
    node poses within 1e-4 (a float32 LU solve of a 192-unknown system in
    each framework, a few LM steps); the banded PGO of windows past 256
    keyframes within the same 1e-4;
  - the loop_run scene through both LoopClosers: the same accepted (i, j)
    pairs, inlier counts within ±1 (a few near-tie descriptor bits may
    flip, tests/test_torch_orb_stereo.py), T_map_odom within 1e-3, and the
    reference test's drift-reduction assertions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.config import LoopConfig as JLoopConfig
from flvis_tpu.geometry import camera as jcam, se3 as jse3, so3 as jso3
from flvis_tpu.io.synthetic import PlanarScene, SceneConfig
from flvis_tpu.loop import bow as jbow, loop_closing as jlc
from flvis_tpu_torch.config import LoopConfig
from flvis_tpu_torch.geometry import camera as tcam, se3 as tse3
from flvis_tpu_torch.loop import bow as tbow, loop_closing as tlc

torch.set_num_threads(1)


def _jax_init_idx(seed, n, num_words):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (num_words,),
                                        replace=n < num_words))


def _jax_draws(monkeypatch):
    """Route the port's two draws through the reference's jax.random calls."""
    real_train = tbow.train

    def train(desc, valid, num_words=1024, iters=8, seed=0, init_idx=None):
        n = int(torch.as_tensor(valid).sum())
        return real_train(desc, valid, num_words, iters, seed,
                          init_idx=_jax_init_idx(seed, n, num_words))

    def scores(i, j, m, n, device):
        u = jax.random.uniform(jax.random.PRNGKey(i * 7919 + j), (m, n))
        return torch.as_tensor(np.asarray(u), device=device)

    monkeypatch.setattr(tlc.bow, "train", train)
    monkeypatch.setattr(tlc, "_verify_scores", scores)


@pytest.mark.parametrize("n,num_words", [(300, 64), (40, 64)])
def test_bow_train_transform_score(n, num_words):
    rng = np.random.default_rng(n)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    valid = rng.uniform(size=n) > 0.1
    jv = jbow.train(jnp.asarray(desc), valid, num_words=num_words, iters=4, seed=3)
    tv = tbow.train(torch.as_tensor(desc.view(np.int32)), torch.as_tensor(valid),
                    num_words=num_words, iters=4, seed=3,
                    init_idx=_jax_init_idx(3, int(valid.sum()), num_words))
    np.testing.assert_array_equal(tv.words_pm1.numpy(), np.asarray(jv.words_pm1))
    np.testing.assert_allclose(tv.idf.numpy(), np.asarray(jv.idf), atol=1e-6)
    rows_j, rows_t = [], []
    for k in range(4):
        d = rng.integers(0, 2 ** 32, (50, 8), dtype=np.uint32)
        v = rng.uniform(size=50) > 0.2
        rows_j.append(np.asarray(jbow.transform(jv, jnp.asarray(d), jnp.asarray(v))))
        rows_t.append(tbow.transform(tv, torch.as_tensor(d.view(np.int32)),
                                     torch.as_tensor(v)).numpy())
    np.testing.assert_allclose(np.stack(rows_t), np.stack(rows_j), atol=1e-6)
    db_valid = np.asarray([True, True, False, True])
    sj = jbow.score_database(jnp.asarray(rows_j[0]), jnp.asarray(np.stack(rows_j)),
                             jnp.asarray(db_valid))
    st = tbow.score_database(torch.as_tensor(rows_t[0]), torch.as_tensor(np.stack(rows_t)),
                             torch.as_tensor(db_valid))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    np.testing.assert_allclose(float(tbow.score(torch.as_tensor(rows_t[1]),
                                                torch.as_tensor(rows_t[2]))),
                               float(jbow.score(jnp.asarray(rows_j[1]),
                                                jnp.asarray(rows_j[2]))), atol=1e-6)


def _inject(n, loops, drift_step=0.01):
    """tests/test_loop_closing.py:_inject_run for both packages."""
    kw = dict(max_keyframes=max(64, n), num_orb_features=32, vocab_words=16)
    args = (200.0, 200.0, 128.0, 96.0, 0.12)
    jl = jlc.LoopCloser(JLoopConfig(**kw), jcam.make(*args, width=256, height=192))
    tl = tlc.LoopCloser(LoopConfig(**kw), tcam.make(*args, width=256, height=192,
                                                    device="cpu"), device="cpu")
    gt = []
    for k in range(n):
        T_gt = jse3.SE3(jso3.identity(), jnp.asarray([-0.1 * k, 0.0, 0.0], jnp.float32))
        T_odo = jse3.SE3(T_gt.q, T_gt.t + jnp.asarray([0.0, drift_step * k, 0.0]))
        gt.append(T_gt)
        T_wc = jse3.inverse(T_odo)
        for name, v in (("q", T_wc.q), ("t", T_wc.t)):
            for suf in ("_odom", ""):
                attr = f"kf_{name}{suf}"
                setattr(jl, attr, getattr(jl, attr).at[k].set(v))
                getattr(tl, attr)[k] = torch.as_tensor(np.asarray(v))
    jl.count = tl.count = n
    for (i, j) in loops:
        T_ij = jse3.compose(gt[i], jse3.inverse(gt[j]))
        jl.closures.append(jlc.LoopClosure(i, j, 50, T_ij))
        tl.closures.append(tlc.LoopClosure(i, j, 50, tse3.SE3(
            torch.as_tensor(np.asarray(T_ij.q)), torch.as_tensor(np.asarray(T_ij.t)))))
    return jl, tl


@pytest.mark.parametrize("n,loops", [(40, [(10, 30)]), (60, [(5, 40), (8, 47), (12, 55)])])
def test_dense_pgo_matches(n, loops):
    jl, tl = _inject(n, loops)
    pre = tl.kf_t[:loops[0][0]].clone()
    jl.optimize_graph()
    tl.optimize_graph()
    np.testing.assert_allclose(tl.kf_t.numpy(), np.asarray(jl.kf_t), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tl.kf_q.numpy(), np.asarray(jl.kf_q), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tl.T_map_odom.t.numpy(), np.asarray(jl.T_map_odom.t),
                               atol=1e-4)
    assert torch.equal(tl.kf_t[:loops[0][0]], pre)       # before the window: untouched


@pytest.mark.parametrize("n,loops", [(300, [(5, 290)]),
                                     (480, [(5, 470), (40, 440), (200, 400)])])
def test_banded_pgo_matches(n, loops):
    """Loop windows past 256 keyframes (both pad to 512 nodes) take the
    banded solver in both packages, at min(pgo_iters, 20) LM steps."""
    jl, tl = _inject(n, loops)
    pre = tl.kf_t[:loops[0][0]].clone()
    calls = []
    real = tlc.pose_graph.optimize_banded

    def banded(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tlc.pose_graph, "optimize_banded", banded)
    try:
        jl.optimize_graph()
        tl.optimize_graph()
    finally:
        mp.undo()
    assert calls == [dict(band_edges=tl.cfg.seq_edge_successors * 512, iters=20)]
    np.testing.assert_allclose(tl.kf_t.numpy(), np.asarray(jl.kf_t), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tl.kf_q.numpy(), np.asarray(jl.kf_q), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tl.T_map_odom.t.numpy(), np.asarray(jl.T_map_odom.t),
                               atol=1e-4)
    assert torch.equal(tl.kf_t[:loops[0][0]], pre)       # before the window: untouched


def _out_and_back(n):
    half = n // 2
    xs = list(np.linspace(0, 0.8, half)) + list(np.linspace(0.8, 0.02, n - half))
    return [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]


@pytest.fixture(scope="module")
def loop_runs():
    """tests/test_loop_closing.py:loop_run through both LoopClosers."""
    mp = pytest.MonkeyPatch()
    _jax_draws(mp)
    try:
        scfg = SceneConfig()
        scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
        kw = dict(max_keyframes=64, num_orb_features=200, vocab_words=128, kf_start=12,
                  kf_dist=10, kf_max_dist=64, nkf_closest=2, min_pts=12, min_score=0.03,
                  ratio_ransac=0.3, seq_edge_successors=3)
        args = (scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline)
        jl = jlc.LoopCloser(JLoopConfig(**kw),
                            jcam.make(*args, width=scfg.width, height=scfg.height))
        tl = tlc.LoopCloser(LoopConfig(**kw), tcam.make(*args, width=scfg.width,
                                                        height=scfg.height, device="cpu"),
                            device="cpu")
        n = 28
        poses = _out_and_back(n)
        gt, odo = [], []
        for k, (R, t) in enumerate(poses):
            q = np.asarray(jso3.from_matrix(jnp.asarray(R, jnp.float32)))
            t_odo = (t + np.asarray([0.0, 0.01 * k, 0.0])).astype(np.float32)
            gt.append((q, t.astype(np.float32)))
            odo.append((q, t_odo))
            img_l, img_r, _ = scene.render(R, t)
            for lc, T in ((jl, jse3.SE3(jnp.asarray(q), jnp.asarray(t_odo))),
                          (tl, tse3.SE3(torch.as_tensor(q), torch.as_tensor(t_odo)))):
                idx = lc.add_keyframe(img_l, img_r, T, frame_id=k)
                if lc.detect_loop(idx) is not None:
                    lc.optimize_graph()
    finally:
        mp.undo()
    return jl, tl, gt, odo, n


def test_loop_run_same_closures(loop_runs):
    jl, tl, _, _, _ = loop_runs
    assert [(c.kf_i, c.kf_j) for c in tl.closures] == [(c.kf_i, c.kf_j) for c in jl.closures]
    assert len(tl.closures) >= 1
    for a, b in zip(tl.closures, jl.closures):
        assert abs(a.num_inliers - b.num_inliers) <= 1
    np.testing.assert_allclose(tl.T_map_odom.t.numpy(), np.asarray(jl.T_map_odom.t),
                               atol=1e-3)
    np.testing.assert_allclose(tl.T_map_odom.q.numpy(), np.asarray(jl.T_map_odom.q),
                               atol=1e-3)


def test_loop_run_reduces_drift(loop_runs):
    """The assertions of tests/test_loop_closing.py:TestLoopClosing."""
    _, tl, gt, odo, n = loop_runs
    c = tl.closures[0]
    assert c.kf_j - c.kf_i >= 10 and c.num_inliers >= 12
    last = n - 1
    C_gt = -gt[last][1]                    # identity rotations: C = −t
    C_odo = -odo[last][1]
    C_corr = tl.kf_T_wc[last].t.numpy()
    err_odo = np.linalg.norm(C_odo - C_gt)
    assert err_odo > 0.2
    assert np.linalg.norm(C_corr - C_gt) < 0.6 * err_odo
    T = tl.corrected_pose(tse3.SE3(torch.as_tensor(odo[last][0]),
                                   torch.as_tensor(odo[last][1])))
    np.testing.assert_allclose(tse3.inverse(T).t.numpy(), C_corr, atol=1e-5)


@pytest.fixture(scope="module")
def dump_runs(tmp_path_factory):
    """tests/test_loop_closing.py:680-720's debug-dump run (14 keyframes out
    and back with injected drift) through both LoopClosers on the
    reference's draws: the port's with dump_dir and pgo_device="cpu", the
    JAX one with dump_dir."""
    dirs = [tmp_path_factory.mktemp(n) for n in ("tdump", "jdump")]
    mp = pytest.MonkeyPatch()
    _jax_draws(mp)
    try:
        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                           baseline=0.12)
        scene = PlanarScene(scfg, plane_depth=8.0, seed=5)
        args = (scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline)
        kw = dict(max_keyframes=32, num_orb_features=128, vocab_words=64, kf_start=6,
                  kf_dist=4, kf_max_dist=32, nkf_closest=1, min_pts=10, min_score=0.02,
                  ratio_ransac=0.25, seq_edge_successors=2)
        tl = tlc.LoopCloser(LoopConfig(**kw), tcam.make(*args, width=256, height=192,
                                                        device="cpu"),
                            device="cpu", pgo_device="cpu", dump_dir=str(dirs[0]))
        jl = jlc.LoopCloser(JLoopConfig(**kw), jcam.make(*args, width=256, height=192),
                            dump_dir=str(dirs[1]), pgo_device=jax.devices()[-1])
        n = 14
        half = n // 2
        xs = list(np.linspace(0, 0.5, half)) + list(np.linspace(0.5, 0.01, n - half))
        for k, x in enumerate(xs):
            t = -np.asarray([x, 0.0, 0.0])
            img_l, img_r, _ = scene.render(np.eye(3), t)
            t_odo = (t + np.asarray([0.0, 0.012 * k, 0.0])).astype(np.float32)
            for lc, T in ((jl, jse3.SE3(jso3.identity(), jnp.asarray(t_odo))),
                          (tl, tse3.SE3(torch.tensor([1.0, 0, 0, 0]), torch.as_tensor(t_odo)))):
                idx = lc.add_keyframe(img_l, img_r, T, frame_id=k)
                if lc.detect_loop(idx) is not None:
                    lc.optimize_graph()
    finally:
        mp.undo()
    return tl, jl, dirs[0]


def test_dump_dir_and_pgo_device(dump_runs):
    """tests/test_loop_closing.py:680-720's assertions on the port
    (pgo_device="cpu"): similarity dumps every 10 keyframes, the pose graph
    before and after each PGO, one match PNG per accepted closure."""
    tl, _, d = dump_runs
    sims = sorted(d.glob("sim_matrix_*.txt"))
    assert len(sims) >= 1
    m = np.loadtxt(sims[0])
    assert m.shape == (10, 10)
    np.testing.assert_allclose(np.diag(m), 1.0, atol=1e-5)
    np.testing.assert_allclose(m, m.T, atol=1e-5)
    S = tl.sim_matrix()
    assert S.shape == (tl.count, tl.count)
    assert tl.closures, "the port's run accepted no closure"
    before = sorted(d.glob("pose_graph_*_before.npz"))
    after = sorted(d.glob("pose_graph_*_after.npz"))
    assert before and len(before) == len(after)
    a = np.load(after[-1])
    assert a["node_q"].shape[1] == 4 and len(a["loops"]) >= 1
    np.testing.assert_array_equal(a["node_t"], tl.kf_t[:tl.count].numpy())
    matches = sorted(d.glob("loop_match_*.png"))
    assert len(matches) == len(tl.closures)
    import cv2

    m0 = cv2.imread(str(matches[0]))
    assert m0 is not None and m0.shape == (192, 512, 3)
    assert tl.kf_q.device.type == "cpu" and tl.pgo_device == torch.device("cpu")


def test_sim_matrix_matches(dump_runs):
    """sim_matrix (and its dumped file) against the JAX LoopCloser's within
    1e-5: the same vocabulary (the reference's draws) over the same ORB
    descriptors."""
    tl, jl, d = dump_runs
    assert tl.count == jl.count == 14
    np.testing.assert_allclose(tl.sim_matrix(), jl.sim_matrix(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.loadtxt(d / "sim_matrix_00010.txt"),
                               np.asarray(jl.sim_matrix())[:10, :10], atol=1e-5, rtol=0)


def test_no_host_images_without_dump_dir(loop_runs):
    """Without dump_dir the loop node keeps no host copy of an image."""
    _, tl, _, _, _ = loop_runs
    assert tl.dump_dir is None and tl._kf_imgs is None and tl.pgo_device is None
