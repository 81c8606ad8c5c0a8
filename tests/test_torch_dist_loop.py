"""flvis_tpu_torch.parallel.dist_loop and LoopCloser(mesh=) — the keyframe-
sharded BoW database over 4 gloo ranks on the CPU:

  - score_database_sharded and best_candidate_sharded against the JAX
    package's on a 4-device `kf` mesh, on the database of
    tests/test_parallel.py:494-520 (K = 64, V = 128), and set_row;
  - LoopCloser(mesh=) on the 10 keyframes of tests/test_loop_closing.py:
    636-669: its sharded scores equal the unsharded LoopCloser's to 1e-5;
  - an out-and-back of 24 keyframes (the scene of tests/test_torch_multiseq.py)
    through LoopCloser(mesh=) stepwise, each keyframe's gate resolved by
    _detect_sharded and verified as a bucket of one: the closures (i, j,
    n_inl) and the PGO-corrected poses of the unsharded loop node, with a
    capacity of 16 keyframes, so the database doubles and is split again
    on the way; the ranks' closures and poses are bit-equal.

The ranks are spawned once for the file; this module imports JAX only
inside its fixture."""

import numpy as np
import pytest
import torch

import flvis_tpu_torch.config as tconfig
from flvis_tpu_torch.geometry import camera as tcam, se3 as tse3, so3 as tso3
from flvis_tpu_torch.io.synthetic import PlanarScene, SceneConfig
from flvis_tpu_torch.loop import bow as tbow
from flvis_tpu_torch.loop.loop_closing import LoopCloser
from flvis_tpu_torch.parallel import dist_loop, multihost

torch.set_num_threads(1)
N_RANKS = 4
SCFG = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                   baseline=0.12)
SCORES_CFG = dict(max_keyframes=32, num_orb_features=128, vocab_words=64, kf_start=4,
                  kf_dist=2, kf_max_dist=32, nkf_closest=1, min_score=0.0)
LOOP_CFG = dict(max_keyframes=16, num_orb_features=128, vocab_words=128, kf_start=10,
                kf_dist=8, kf_max_dist=64, nkf_closest=2, min_pts=12, min_score=0.03,
                ratio_ransac=0.3, seq_edge_successors=3)
N_KF = 24


def _cam():
    return tcam.make(SCFG.fx, SCFG.fy, SCFG.cx, SCFG.cy, SCFG.baseline, width=SCFG.width,
                     height=SCFG.height, device="cpu")


def _db(K=64, V=128):
    db = np.random.default_rng(0).uniform(0, 1, (K, V)).astype(np.float32)
    return db / np.abs(db).sum(axis=1, keepdims=True)


def _score_frames():
    scene = PlanarScene(SCFG, plane_depth=8.0, seed=3)
    return [(scene.render(np.eye(3), np.asarray([0.05 * k, 0.0, 0.0], np.float32))[:2],
             np.asarray([0.05 * k, 0.0, 0.0], np.float32)) for k in range(10)]


def _loop_frames():
    scene = PlanarScene(SCFG, plane_depth=8.0, seed=11)
    xs = list(np.linspace(0, 0.9, N_KF // 2)) + list(np.linspace(0.9, 0.02, N_KF - N_KF // 2))
    return [(scene.render(np.eye(3), -np.asarray([x, 0.0, 0.0]))[:2],
             -np.asarray([x, 0.0, 0.0], np.float32)) for x in xs]


def _pose(t):
    return tse3.SE3(tso3.identity(()), torch.as_tensor(t))


def _run_loop(lc, frames):
    """The keyframes through lc stepwise, PGO after each accepted closure."""
    for k, ((il, ir), t) in enumerate(frames):
        lc.add_keyframe(il, ir, _pose(t), frame_id=k)
        if lc.detect_loop(k) is not None:
            lc.optimize_graph()
    return ([(c.kf_i, c.kf_j, c.num_inliers) for c in lc.closures],
            lc.kf_t[:lc.count].numpy(), lc.kf_q[:lc.count].numpy())


def _rank(db, score_frames, loop_frames):
    mesh = dist_loop.make_kf_mesh("cpu")
    out = {}
    K = db.shape[0]
    dbt = torch.as_tensor(db)
    db_l, valid_l = dist_loop.shard_db(mesh, dbt, torch.arange(K) < 40)
    out["scores"] = dist_loop.score_database_sharded(mesh, dbt[7], db_l, valid_l).numpy()
    db_l, valid_l = dist_loop.shard_db(mesh, dbt, torch.ones(K, dtype=torch.bool))
    v, i = dist_loop.best_candidate_sharded(mesh, dbt[37], db_l, valid_l,
                                            dist_loop.shard_rows(mesh, torch.arange(K) < 30))
    out["best"] = (float(v), int(i))
    zero, _ = dist_loop.shard_db(mesh, torch.zeros_like(dbt), torch.zeros(K, dtype=torch.bool))
    row = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, 128).astype(np.float32))
    dist_loop.set_row(mesh, zero, 5, row)
    out["set_row"] = (dist_loop.get_row(mesh, zero, 5).numpy(),
                      dist_loop.get_row(mesh, zero, 6).numpy())

    lc = LoopCloser(tconfig.LoopConfig(**SCORES_CFG), _cam(), device="cpu", mesh=mesh)
    for k, ((il, ir), t) in enumerate(score_frames):
        lc.add_keyframe(il, ir, _pose(t), frame_id=k)
    own = dist_loop.row_range(mesh, lc.bow_db)
    valid = torch.arange(own.start, own.stop) < lc.count
    out["lc_scores"] = {k: dist_loop.score_database_sharded(
        mesh, dist_loop.get_row(mesh, lc.bow_db, k), lc.bow_db, valid).numpy() for k in (6, 9)}

    lc = LoopCloser(tconfig.LoopConfig(**LOOP_CFG), _cam(), device="cpu", mesh=mesh)
    out["loop"] = _run_loop(lc, loop_frames)
    out["capacity"] = (lc.capacity, lc.bow_db.shape[0])
    return out


@pytest.fixture(scope="module")
def runs():
    import jax.numpy as jnp

    from flvis_tpu.loop import bow as jbow
    from flvis_tpu.parallel import dist_loop as jdist

    db = _db()
    mesh = jdist.make_kf_mesh(N_RANKS)
    jdb = jnp.asarray(db)
    valid = jnp.asarray(np.arange(64) < 40)
    db_sh, valid_sh = jdist.shard_db(mesh, jdb, valid)
    jax_scores = np.asarray(jdist.score_database_sharded(mesh, jdb[7], db_sh, valid_sh))
    jax_dense = np.asarray(jbow.score_database(jdb[7], jdb, valid))
    db_sh, valid_sh = jdist.shard_db(mesh, jdb, jnp.ones(64, bool))
    v, i = jdist.best_candidate_sharded(mesh, jdb[37], db_sh, valid_sh,
                                        jnp.asarray(np.arange(64) < 30))
    score_frames, loop_frames = _score_frames(), _loop_frames()
    lc = LoopCloser(tconfig.LoopConfig(**SCORES_CFG), _cam(), device="cpu")
    for k, ((il, ir), t) in enumerate(score_frames):
        lc.add_keyframe(il, ir, _pose(t), frame_id=k)
    valid = torch.arange(32) < lc.count
    dense_scores = {k: tbow.score_database(lc.bow_db[k], lc.bow_db, valid).numpy()
                    for k in (6, 9)}
    dense_loop = _run_loop(LoopCloser(tconfig.LoopConfig(**LOOP_CFG), _cam(), device="cpu"),
                           loop_frames)
    ranks = multihost.spawn(_rank, N_RANKS, (db, score_frames, loop_frames),
                            device_type="cpu", threads=1)
    return dict(db=db, jax=(jax_scores, jax_dense, float(v), int(i)),
                dense=(dense_scores, dense_loop), ranks=ranks)


def test_sharded_scores_and_best_candidate(runs):
    jax_scores, jax_dense, jv, ji = runs["jax"]
    db = runs["db"]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["scores"], jax_scores, atol=1e-6)
        np.testing.assert_allclose(r["scores"], jax_dense, atol=1e-6)
        s = 1.0 - 0.5 * np.abs(db - db[37]).sum(axis=1)
        s[30:] = -np.inf
        assert r["best"][1] == int(np.argmax(s)) == ji
        np.testing.assert_allclose(r["best"][0], s[ji], atol=1e-6)
        np.testing.assert_allclose(r["best"][0], jv, atol=1e-6)


def test_set_row_writes_the_owner_only(runs):
    row = np.random.default_rng(1).uniform(0, 1, 128).astype(np.float32)
    for r in runs["ranks"]:
        got5, got6 = r["set_row"]
        np.testing.assert_array_equal(got5, row)
        assert got6.sum() == 0


def test_loop_closer_mesh_scores_match_dense(runs):
    dense_scores, _ = runs["dense"]
    for r in runs["ranks"]:
        for k in (6, 9):
            np.testing.assert_allclose(r["lc_scores"][k], dense_scores[k], atol=1e-5)


def test_detect_sharded_closes_the_dense_loops(runs):
    _, (closures, kf_t, kf_q) = runs["dense"]
    r0 = runs["ranks"][0]
    assert len(closures) >= 1
    assert r0["capacity"] == (32, 32 // N_RANKS)          # grown from 16 and split again
    got_closures, got_t, got_q = r0["loop"]
    assert got_closures == closures
    np.testing.assert_allclose(got_t, kf_t, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_q, kf_q, atol=1e-5, rtol=0)
    for r in runs["ranks"][1:]:
        assert r["loop"][0] == got_closures
        np.testing.assert_array_equal(r["loop"][1], got_t)
        np.testing.assert_array_equal(r["loop"][2], got_q)
