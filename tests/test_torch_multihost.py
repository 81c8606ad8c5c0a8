"""flvis_tpu_torch.parallel.multihost, the `seq`-sharded multiseq chunks
and MultiSeqSlam(mesh=) over 2 gloo ranks on the CPU:

  - initialize's single-process no-op and its ValueError without a
    coordinator, host_sequence_slice and the backend rule
    (tests/test_parallel.py:422-442);
  - a rank's block of 2 sequences through system_chunk_batch on 2 ranks
    against the JAX package's system_chunk_batch_sharded on a 4-device
    `seq` mesh (tests/test_parallel.py:57-116:
    4 sequences of 4 frames, a scene each), the reference's draws handed to
    the port: statuses and keyframes equal, translations within 1e-3;
  - MultiSeqSlam(mesh=) over 2 ranks × 2 sequences (stereo, a loop node a
    sequence, ba_every=2, pipelined; 24 frames of the out-and-back of
    tests/test_torch_multiseq.py, sequence s rolled by 7·s px) against the
    one-process port run of the 4 sequences: per sequence the same packed
    outputs, trajectory, closures and loop-corrected centres, bit for bit;
  - the meshed checkpoint: save_multiseq after the second chunk (the
    primary writes one file set), loaded back by each rank into a fresh
    meshed system and by one process into an unmeshed one, bit-equal.

The ranks are spawned once for the file; this module imports JAX only
inside its fixture."""

import numpy as np
import pytest
import torch

import flvis_tpu_torch.config as tconfig
from flvis_tpu_torch import interop
from flvis_tpu_torch.frontend import tracker as ttr
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory
from flvis_tpu_torch.parallel import mesh as mesh_m, multihost, multiseq
from flvis_tpu_torch.parallel.multiseq_loop import MultiSeqSlam
from flvis_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
N_RANKS = 2
SCFG = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                   baseline=0.12)
CAM_ARGS = (200.0, 200.0, 128.0, 96.0, 0.12)
DP_FE = dict(width=256, height=192, num_slots=64, pyramid_levels=3, per_cell=4,
             min_distance=10.0, margin=12, lk_radius=7, ransac_hypotheses=32,
             kf_bootstrap_every=2)
DP_BA = dict(window_size=4, max_landmarks=128, min_views=2, iters1=4, iters2=3,
             pallas_schur=False)
S_DP, T_DP = 4, 4
S, N, CHUNK, ROLL = 4, 24, 8, 7


def _cam():
    return tcam.make(*CAM_ARGS, width=SCFG.width, height=SCFG.height, device="cpu")


def _ms_cfg():
    """The configuration of tests/test_multiseq_loop.py:37-49."""
    return tconfig.SystemConfig(
        frontend=tconfig.FrontendConfig(width=SCFG.width, height=SCFG.height, num_slots=128,
                                        pyramid_levels=3, per_cell=8, min_distance=12.0,
                                        margin=22, kf_min_trans=0.04, pnp_fallback=False),
        backend=tconfig.BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4,
                                      pallas_schur=False),
        loop=tconfig.LoopConfig(max_keyframes=64, num_orb_features=128, vocab_words=128,
                                kf_start=10, kf_dist=8, kf_max_dist=64, nkf_closest=2,
                                min_pts=12, min_score=0.03, ratio_ransac=0.3,
                                seq_edge_successors=3))


def _ms_frames():
    """(S, N, H, W) stereo stacks: the out-and-back, sequence s rolled 7·s px."""
    sc = PlanarScene(SCFG, plane_depth=8.0, seed=11)
    xs = list(np.linspace(0, 0.9, N // 2)) + list(np.linspace(0.9, 0.02, N - N // 2))
    fr = [sc.render(np.eye(3), -np.asarray([x, 0.0, 0.0]))[:2] for x in xs]
    i0, i1 = np.stack([f[0] for f in fr]), np.stack([f[1] for f in fr])
    return tuple(np.stack([np.roll(a, ROLL * s, axis=2) for s in range(S)]) for a in (i0, i1))


def _ms(mesh=None):
    return MultiSeqSlam(_ms_cfg(), _cam(), num_seqs=S, use_loop=True, ba_every=2,
                        pipelined=True, device="cpu", mesh=mesh)


def _ms_state(ms):
    """A system's per-sequence states, trajectories and closures (host)."""
    return {"fe": [interop.to_numpy(x) for x in ms.fe], "ba": [interop.to_numpy(x) for x in ms.ba],
            "corr": [interop.to_numpy(x) for x in ms.corr],
            "traj": [[(f, t, q.copy(), tt.copy()) for (f, t, q, tt) in tr]
                     for tr in ms.trajectories],
            "closures": [[(c.kf_i, c.kf_j, c.num_inliers) for c in lc.closures]
                         for lc in ms.loopers]}


def _drive(ms, frames, at_ckpt):
    """The 3 chunks, a flush and at_ckpt(ms) after the second, then flush;
    returns the packed rows of every chunk."""
    i0, i1 = frames
    rets = []
    for c, c0 in enumerate(range(0, N, CHUNK)):
        rets.append(ms.process_chunk(i0[:, c0:c0 + CHUNK], i1[:, c0:c0 + CHUNK]))
        if c == 1:
            rets.append(ms.flush())
            at_ckpt(ms)
    rets.append(ms.flush())
    return [r for r in rets if r is not None]


def _table_track_frame(table, real):
    """track_frame on the draws of `table` [frame id][tracking?]."""
    def track_frame(fcfg, cam, state, img0, img1, **kw):
        kw.pop("generator", None)
        kw.pop("draws", None)
        d = table[int(state.frame_id)][int(int(state.status) == ttr.STATUS_TRACKING)]
        return real(fcfg, cam, state, img0, img1, draws=d, **kw)

    return track_frame


def _rank(dp_frames, table, ckpt):
    mesh = multiseq.make_mesh("cpu")
    out = {}
    # The rank's block through system_chunk_batch, on the reference's draws.
    fcfg, bcfg = tconfig.FrontendConfig(**DP_FE), tconfig.BackendConfig(**DP_BA)
    real = ttr.track_frame
    ttr.track_frame = _table_track_frame(table, real)
    try:
        fe, ba, corr = multiseq.init_system_states(fcfg, bcfg, S_DP, mesh)
        i0, i1 = (multiseq.shard_batch(mesh, a) for a in dp_frames)
        cams = multiseq.shard_batch(mesh, [_cam()] * S_DP)
        gens = [torch.Generator().manual_seed(0) for _ in cams]
        *_, outs, costs = multiseq.system_chunk_batch(fcfg, bcfg, cams, fe, ba, corr, i0, i1,
                                                      gens)
    finally:
        ttr.track_frame = real
    out["dp"] = (interop.to_numpy(outs), costs.numpy())

    # MultiSeqSlam over the mesh, checkpointed after the second chunk.
    frames = _ms_frames()
    ms = _ms(mesh)
    rets = _drive(ms, frames, lambda m: checkpoint.save_multiseq(ckpt, m))
    out["seqs"] = list(ms.seqs)
    out["rows"] = rets
    out["state"] = _ms_state(ms)
    out["centres"] = [ms.trajectory_cam_centers(s, loop_corrected=True) for s in range(S)]
    # The checkpoint loaded into a fresh meshed system equals the saved one.
    ms2 = _ms(mesh)
    checkpoint.load_multiseq(ckpt, ms2)
    out["loaded"] = _ms_state(ms2)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import flvis_tpu.config as jconfig
    from flvis_tpu.geometry import camera as jcam
    from flvis_tpu.io.synthetic import PlanarScene as JPlanarScene
    from flvis_tpu.parallel import multiseq as jms

    # The DP chunk of tests/test_parallel.py:57-116 on a 4-device seq mesh.
    jf, jb = jconfig.FrontendConfig(**DP_FE), jconfig.BackendConfig(**DP_BA)
    seq = []
    for s in range(S_DP):
        scene = JPlanarScene(SCFG, plane_depth=8.0, seed=s)
        fr = [scene.render(R, t) for (R, t) in orbit_trajectory(T_DP, step=0.04)]
        seq.append((np.stack([f[0] for f in fr]), np.stack([f[1] for f in fr])))
    dp_frames = tuple(np.stack([x[k] for x in seq]).astype(np.float32) for k in (0, 1))
    mesh = jms.make_mesh(S_DP)
    cam1 = jcam.make(*CAM_ARGS, width=256, height=192)
    cams = jax.tree.map(lambda a: jnp.broadcast_to(jnp.asarray(a),
                                                   (S_DP,) + jnp.shape(jnp.asarray(a))), cam1)
    fe, ba, corr = jms.init_system_states(jf, jb, S_DP, mesh)
    _, _, _, jouts, _ = jms.system_chunk_batch_sharded(
        mesh, jf, jb, jms.shard_batch(mesh, cams), fe, ba, corr,
        jms.shard_batch(mesh, jnp.asarray(dp_frames[0])),
        jms.shard_batch(mesh, jnp.asarray(dp_frames[1])))
    jouts = jax.tree.map(np.asarray, jouts)

    # The reference's draws of each frame, tracking or not (tracker.py:515-516).
    h, n = jf.ransac_hypotheses, jf.num_slots
    lo, hi = jf.dummy_depth_range
    table = []
    for i in range(T_DP):
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        k_r, k_d, k_p = jax.random.split(key, 3)
        variants = [(jnp.zeros((h, n)), jnp.zeros((h, n)),
                     jax.random.uniform(key, (n,), jnp.float32, lo, hi)),
                    (jax.random.uniform(k_r, (h, n)), jax.random.uniform(k_p, (h, n)),
                     jax.random.uniform(k_d, (n,), jnp.float32, lo, hi))]
        table.append([ttr.Draws(*(torch.as_tensor(np.array(a)) for a in v))
                      for v in variants])

    # The one-process port run of the 4 sequences, flushed after chunk 2.
    # (and its state at the checkpoint's point).
    frames = _ms_frames()
    one, at = _ms(), []
    rows = _drive(one, frames, lambda m: at.append(_ms_state(m)))
    one_state = _ms_state(one)
    one_centres = [one.trajectory_cam_centers(s, loop_corrected=True) for s in range(S)]

    ckpt = str(tmp_path_factory.mktemp("ckpt") / "multiseq.npz")
    ranks = multihost.spawn(_rank, N_RANKS, (dp_frames, table, ckpt), device_type="cpu",
                            threads=1)
    reloaded = _ms()
    checkpoint.load_multiseq(ckpt, reloaded)
    return dict(jouts=jouts, one=(rows, one_state, one_centres), at_ckpt=at[0],
                reloaded=_ms_state(reloaded), ranks=ranks)


def test_initialize_single_process_is_noop():
    multihost.initialize(num_processes=1)
    assert multihost.process_count() == 1
    assert multihost.is_primary()


def test_initialize_requires_coordinator():
    with pytest.raises(ValueError):
        multihost.initialize(num_processes=2, process_id=0, device_type="cpu")


def test_host_sequence_slice_and_backend_rule():
    one = mesh_m.Mesh("seq", 1, 0, torch.device("cpu"))
    sl = multihost.host_sequence_slice(16, one)
    assert (sl.start, sl.stop) == (0, 16)
    sl = multihost.host_sequence_slice(16, mesh_m.Mesh("seq", 8, 3, torch.device("cpu")))
    assert (sl.start, sl.stop) == (6, 8)
    with pytest.raises(ValueError):
        multihost.host_sequence_slice(10, mesh_m.Mesh("seq", 8, 0, torch.device("cpu")))
    assert mesh_m.backend_for("cpu", 2, 0) == "gloo"
    assert mesh_m.backend_for("cuda", 2, 1) == "gloo"         # two ranks share a card
    assert mesh_m.backend_for("cuda", 2, 2) == "nccl"
    local = multihost.make_global_batch(one, (np.zeros((2, 3)), np.ones((2, 1))))
    assert [tuple(a.shape) for a in local] == [(2, 3), (2, 1)]


def test_system_chunk_batch_sharded_matches_jax(runs):
    jouts = runs["jouts"]
    for r, rank in enumerate(runs["ranks"]):
        outs, costs = rank["dp"]
        sl = slice(r * S_DP // N_RANKS, (r + 1) * S_DP // N_RANKS)
        np.testing.assert_array_equal(outs["status"], jouts.status[sl])
        np.testing.assert_array_equal(outs["is_keyframe"], jouts.is_keyframe[sl])
        np.testing.assert_allclose(outs["T_c_w"]["t"], jouts.T_c_w.t[sl], atol=1e-3, rtol=0)
        assert costs.shape == (S_DP // N_RANKS, T_DP)
    assert jouts.is_keyframe.any()


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_meshed_multiseq_matches_one_process_bit_for_bit(runs):
    rows, state, centres = runs["one"]
    for rank in runs["ranks"]:
        seqs = rank["seqs"]
        assert len(seqs) == S // N_RANKS
        for got, ref in zip(rank["rows"], rows):
            np.testing.assert_array_equal(got, ref[seqs[0]:seqs[-1] + 1])
        for k in state:
            _assert_same(rank["state"][k], state[k][seqs[0]:seqs[-1] + 1])
        for s in range(S):
            np.testing.assert_array_equal(rank["centres"][s], centres[s])
    assert all(len(c) >= 1 for c in state["closures"])


def test_meshed_checkpoint_round_trip(runs):
    at = runs["at_ckpt"]
    _assert_same(runs["reloaded"], at)
    for rank in runs["ranks"]:
        seqs = rank["seqs"]
        _assert_same(rank["loaded"], {k: v[seqs[0]:seqs[-1] + 1] for k, v in at.items()})
