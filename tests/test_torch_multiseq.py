"""flvis_tpu_torch.parallel.multiseq_loop.MultiSeqSlam against the JAX
package's MultiSeqSlam: S = 2 sequences of the 24-frame out-and-back of
tests/test_multiseq_loop.py:34-60, with the window BA per keyframe
(ba_every=1) and every second frame (ba_every=2), in chunks of 8.  This
file runs the stereo path at ba_every=1 on two identical sequences;
test_torch_multiseq_ba2.py, test_torch_multiseq_vio.py and
test_torch_multiseq_vio_ba2.py run the same checks on the other three (one
JAX MultiSeqSlam compile per file keeps each file within its time budget),
the last with sequence 1 rolled horizontally by 7 px (bench.py:411-418) so
that each sequence must keep its own state, window, correction and loop
node.  The ba_every=2 runs of the port are pipelined (results one chunk
late, drained by flush()).

The reference's draws are handed to the port: the tracker's per-frame key
fold_in(PRNGKey(7), frame_id) (the same for every sequence), bow.train's
centroids and the verification's RANSAC scores; the JAX package's loop
ingest runs its Pallas sweep kernel (interpret mode), whose float32
semantics the port follows.

The asserts of tests/test_multiseq_loop.py:89-109: per sequence the same
keyframe count and closure pairs, trajectories (odometry and
loop-corrected) within 1e-3 and T_map_odom.t within 1e-3 (float rounding
of the two frameworks through BA feedback and the PGO); and the port's two
identical sequences agree exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flvis_tpu.config as jconfig
import flvis_tpu_torch.config as tconfig
from flvis_tpu.frontend import tracker as jtr
from flvis_tpu.geometry import camera as jcam
from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, imu_from_trajectory
from flvis_tpu.ops import stereo as jstereo
from flvis_tpu.parallel.multiseq_loop import MultiSeqSlam as JaxMultiSeq
from flvis_tpu.pipeline.runner import pack_imu_frames
from flvis_tpu_torch.frontend import tracker as ttr
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.loop import bow as tbow, loop_closing as tlc
from flvis_tpu_torch.parallel.multiseq_loop import MultiSeqSlam
from flvis_tpu_torch.pipeline import runner as trunner

torch.set_num_threads(1)
SCFG = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                   baseline=0.12)
CAM_ARGS = (SCFG.fx, SCFG.fy, SCFG.cx, SCFG.cy, SCFG.baseline)
N, CHUNK, S = 24, 8, 2


def _cfg(mod):
    """The configuration of tests/test_multiseq_loop.py:37-49, from `mod`."""
    return mod.SystemConfig(
        frontend=mod.FrontendConfig(width=SCFG.width, height=SCFG.height, num_slots=128,
                                    pyramid_levels=3, per_cell=8, min_distance=12.0,
                                    margin=22, kf_min_trans=0.04, pnp_fallback=False),
        backend=mod.BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4,
                                  pallas_schur=False),
        loop=mod.LoopConfig(max_keyframes=64, num_orb_features=128, vocab_words=128,
                            kf_start=10, kf_dist=8, kf_max_dist=64, nkf_closest=2,
                            min_pts=12, min_score=0.03, ratio_ransac=0.3,
                            seq_edge_successors=3))


def _jax_draws(mp):
    """The reference's jax.random draws into the port (tracker.py:515-516,
    bow.py:48-50, loop_closing.py:977)."""
    real_track, real_train = ttr.track_frame, tbow.train

    def track_frame(fcfg, cam, state, img0, img1, **kw):
        kw.pop("generator", None)
        kw.pop("draws", None)      # replaced by the reference's draws
        key = jax.random.fold_in(jax.random.PRNGKey(7), int(state.frame_id))
        h, n = fcfg.ransac_hypotheses, fcfg.num_slots
        lo, hi = fcfg.dummy_depth_range
        if int(state.status) == jtr.STATUS_TRACKING:
            k_r, k_d, k_p = jax.random.split(key, 3)
            arrs = (jax.random.uniform(k_r, (h, n)), jax.random.uniform(k_p, (h, n)),
                    jax.random.uniform(k_d, (n,), jnp.float32, lo, hi))
        else:
            arrs = (jnp.zeros((h, n)), jnp.zeros((h, n)),
                    jax.random.uniform(key, (n,), jnp.float32, lo, hi))
        draws = ttr.Draws(*(torch.as_tensor(np.array(a)) for a in arrs))
        return real_track(fcfg, cam, state, img0, img1, draws=draws, **kw)

    def train(desc, valid, num_words=1024, iters=8, seed=0, init_idx=None):
        n = int(torch.as_tensor(valid).sum())
        idx = jax.random.choice(jax.random.PRNGKey(seed), n, (num_words,),
                                replace=n < num_words)
        return real_train(desc, valid, num_words, iters, seed, init_idx=np.asarray(idx))

    def scores(i, j, m, n, device):
        u = jax.random.uniform(jax.random.PRNGKey(i * 7919 + j), (m, n))
        return torch.as_tensor(np.asarray(u), device=device)

    mp.setattr(trunner.tracker, "track_frame", track_frame)
    mp.setattr(tlc.bow, "train", train)
    mp.setattr(tlc, "_verify_scores", scores)


@pytest.fixture(scope="module")
def scene():
    sc = PlanarScene(SCFG, plane_depth=8.0, seed=11)
    xs = list(np.linspace(0, 0.9, N // 2)) + list(np.linspace(0.9, 0.02, N - N // 2))
    poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    frames = [sc.render(R, t) for (R, t) in poses]
    t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
    accs, gyros, imuts, prev = [], [], [], -np.inf
    for ft in frame_t:
        m = (t_imu > prev) & (t_imu <= ft)
        accs.append(acc[m]); gyros.append(gyro[m]); imuts.append(t_imu[m])
        prev = ft
    return (np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]), frame_t,
            accs, gyros, imuts)


def _drive(ms, scene, vio, roll):
    """Replay the scene through a MultiSeqSlam in chunks, sequence 1's
    frames rolled horizontally by `roll` px; returns what each
    process_chunk* call and flush() returned."""
    i0, i1, frame_t, accs, gyros, imuts = scene

    def bc(a):
        return np.broadcast_to(np.asarray(a), (S,) + np.shape(a))

    def seqs(imgs):
        return np.stack([np.roll(imgs, roll * s, axis=2) for s in range(S)])

    rets = []
    for c0 in range(0, N, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        if vio:
            packed = pack_imu_frames(accs[sl], gyros[sl], imuts[sl], 16)
            rets.append(ms.process_chunk_vio(seqs(i0[sl]), seqs(i1[sl]),
                                             bc(np.asarray(frame_t[sl], np.float32)),
                                             *map(bc, packed)))
        else:
            rets.append(ms.process_chunk(seqs(i0[sl]), seqs(i1[sl])))
    rets.append(ms.flush())
    return rets


def build_runs(mode, ba_every, scene, roll=0):
    """The JAX package's and the port's MultiSeqSlam over the scene
    (sequence 1 rolled by `roll` px)."""
    vio = mode == "vio"
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jstereo, "disparity_sweep",
                   functools.partial(jstereo.disparity_sweep, use_kernel=True))
        jms = JaxMultiSeq(_cfg(jconfig), jcam.make(*CAM_ARGS, width=SCFG.width,
                                                   height=SCFG.height),
                          num_seqs=S, use_imu=vio, use_loop=True, ba_every=ba_every)
        _drive(jms, scene, vio, roll)
        _jax_draws(mp)
        tms = MultiSeqSlam(_cfg(tconfig), tcam.make(*CAM_ARGS, width=SCFG.width,
                                                    height=SCFG.height, device="cpu"),
                           num_seqs=S, use_imu=vio, use_loop=True, ba_every=ba_every,
                           pipelined=ba_every == 2, device="cpu")
        rets = _drive(tms, scene, vio, roll)
    finally:
        mp.undo()
    return jms, tms, rets


@pytest.fixture(scope="module")
def runs(scene):
    return build_runs("stereo", 1, scene)


def _pairs(lc):
    return [(c.kf_i, c.kf_j) for c in lc.closures]


def test_closures_match(runs):
    jms, tms, _ = runs
    for s in range(S):
        assert tms.loopers[s].count == jms.loopers[s].count
        assert _pairs(tms.loopers[s]) == _pairs(jms.loopers[s])
        assert len(_pairs(tms.loopers[s])) >= 1


def test_trajectories_match(runs):
    jms, tms, _ = runs
    for s in range(S):
        t_t = np.asarray([t for (_, _, _, t) in tms.trajectories[s]])
        t_j = np.asarray([t for (_, _, _, t) in jms.trajectories[s]])
        assert t_t.shape == (N, 3)
        np.testing.assert_allclose(t_t, t_j, atol=1e-3, rtol=0)


def test_drift_matches(runs):
    jms, tms, _ = runs
    for s in range(S):
        np.testing.assert_allclose(tms.loopers[s].T_map_odom.t.numpy(),
                                   np.asarray(jms.loopers[s].T_map_odom.t), atol=1e-3)


def test_loop_corrected_centres_match(runs):
    jms, tms, _ = runs
    for s in range(S):
        np.testing.assert_allclose(tms.trajectory_cam_centers(s, loop_corrected=True),
                                   jms.trajectory_cam_centers(s, loop_corrected=True),
                                   atol=1e-3, rtol=0)


def test_sequences_agree_and_return_lag(runs):
    """Identical sequences give identical runs; pipelined runs return None
    first and every chunk's (S, T, 12) outputs after it."""
    _, tms, rets = runs
    a, b = tms.loopers
    assert _pairs(a) == _pairs(b)
    np.testing.assert_array_equal(tms.trajectory_cam_centers(0, loop_corrected=True),
                                  tms.trajectory_cam_centers(1, loop_corrected=True))
    check_return_lag(tms, rets)


def check_return_lag(tms, rets):
    """Pipelined runs return None first, synchronous ones after flush();
    every chunk's (S, T, 12) outputs come back, every frame TRACKING."""
    outs = [r for r in rets if r is not None]
    if tms.pipelined:
        assert rets[0] is None and len(outs) == N // CHUNK
    else:
        assert rets[-1] is None and len(outs) == N // CHUNK
    st = np.concatenate([o[:, :, 2] for o in outs], axis=1)
    assert st.shape == (S, N) and (st[:, 1:] == 1).all()


def test_batched_tracking_matches_single_sequence(scene):
    """track_frame_batch and track_frames_scan_batch on two sequences fed the
    same frames and seeds step each exactly as the single-sequence tracker
    (with the batched runs' pnp_fallback=False)."""
    import dataclasses

    from flvis_tpu_torch.frontend import tracker
    from flvis_tpu_torch.parallel import multiseq

    i0, i1 = (torch.as_tensor(a[:4]) for a in scene[:2])
    fcfg = dataclasses.replace(_cfg(tconfig).frontend, pnp_fallback=True)
    cam = tcam.make(*CAM_ARGS, width=SCFG.width, height=SCFG.height, device="cpu")
    gens = [torch.Generator().manual_seed(5) for _ in range(S)]
    states, outs = multiseq.track_frames_scan_batch(
        fcfg, [cam] * S, multiseq.init_states(fcfg, S, device="cpu"),
        torch.stack([i0] * S), torch.stack([i1] * S), gens)
    one, one_outs = tracker.track_frames_scan(
        dataclasses.replace(fcfg, pnp_fallback=False), cam,
        tracker.init_state(fcfg, device="cpu"), i0, i1, torch.Generator().manual_seed(5))
    assert outs.status.shape == (S, 4)
    for s in range(S):
        assert torch.equal(outs.T_c_w.t[s], one_outs.T_c_w.t)
        assert torch.equal(states[s].table.uv, one.table.uv)
    gens = [torch.Generator().manual_seed(5) for _ in range(S)]
    states, out = multiseq.track_frame_batch(
        fcfg, [cam] * S, multiseq.init_states(fcfg, S, device="cpu"),
        torch.stack([i0[0]] * S), torch.stack([i1[0]] * S), gens)
    assert torch.equal(out.T_c_w.t[0], one_outs.T_c_w.t[0])
    assert torch.equal(out.status, torch.stack([one_outs.status[0]] * S))


def test_mesh_not_ported_raises(runs, scene):
    """MultiSeqSlam(mesh=) is ported (the name is kept from when it raised):
    over a `seq` mesh of one rank it holds every sequence and gives the
    unmeshed run's trajectories, closures and loop-corrected centres bit
    for bit (2 ranks: tests/test_torch_multihost.py)."""
    from flvis_tpu_torch.parallel import mesh as mesh_m

    _, tms, _ = runs
    mp = pytest.MonkeyPatch()
    try:
        _jax_draws(mp)
        ms = MultiSeqSlam(_cfg(tconfig), tcam.make(*CAM_ARGS, width=SCFG.width,
                                                   height=SCFG.height, device="cpu"),
                          num_seqs=S, use_loop=True,
                          mesh=mesh_m.Mesh("seq", 1, 0, torch.device("cpu")))
        _drive(ms, scene, False, 0)
    finally:
        mp.undo()
    assert list(ms.seqs) == list(range(S))
    for s in range(S):
        assert _pairs(ms.loopers[s]) == _pairs(tms.loopers[s])
        np.testing.assert_array_equal(
            np.asarray([t for (*_, t) in ms.trajectories[s]]),
            np.asarray([t for (*_, t) in tms.trajectories[s]]))
        np.testing.assert_array_equal(ms.trajectory_cam_centers(s, loop_corrected=True),
                                      tms.trajectory_cam_centers(s, loop_corrected=True))
