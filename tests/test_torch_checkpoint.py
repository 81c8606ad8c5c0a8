"""utils/checkpoint of the port against the JAX package's: the same file
format and key names, so a checkpoint written by either package loads into
the other (tests/test_checkpoint.py's cases, each also across the
packages).

The port's SlamSystem runs on the reference's draws of every frame (the
runner's track_frame wrapped as in tests/test_torch_runner.py), so both
packages make the same discrete decisions.  Tolerances: a loaded state
equals the saved one exactly (same arrays, same bits); the resumed run
against the straight-through run within tests/test_checkpoint.py's 5e-3 m
on camera centres (the pending correction at the checkpoint is dropped, as
in the reference); the port's resumed run against the JAX resumed run
within tests/test_torch_runner.py's 2e-4 m."""

import dataclasses

import numpy as np
import pytest
import torch

import flvis_tpu.config as jconfig
import flvis_tpu_torch.config as tconfig
from flvis_tpu.frontend import tracker as jtr
from flvis_tpu.geometry import camera as jcam
from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory
from flvis_tpu.pipeline.runner import SlamSystem as JaxSlam
from flvis_tpu.utils import checkpoint as jckpt
from flvis_tpu_torch.frontend import tracker as ttr
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.pipeline import runner as trunner
from flvis_tpu_torch.utils import checkpoint as tckpt
from test_torch_runner import _with_jax_draws

torch.set_num_threads(1)
N_FRAMES, CUT = 10, 5


def _leaves(npz_path):
    with np.load(npz_path) as d:
        return {k: d[k] for k in d.files}


def _assert_same_arrays(a: dict, b: dict, keys=None):
    for k in keys if keys is not None else a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# ------------------------------------------------------------------- pytrees
def _fcfg(mod, slots=16):
    return mod.FrontendConfig(width=128, height=96, num_slots=slots, pyramid_levels=2,
                              per_cell=2, margin=8)


def test_tracker_state_roundtrip(tmp_path):
    """tests/test_checkpoint.py:14-23 on the port, and across: the port's
    file has the JAX file's keys, and each package loads the other's."""
    st = ttr.init_state(_fcfg(tconfig), device="cpu")
    st = dataclasses.replace(st, frame_id=torch.tensor(7, dtype=torch.int32),
                             velocity=torch.arange(6, dtype=torch.float32))
    p = str(tmp_path / "st.npz")
    tckpt.save_pytree(p, st)
    st2 = tckpt.load_pytree(p, ttr.init_state(_fcfg(tconfig), device="cpu"))
    assert type(st2) is type(st)
    for (k, a), (_, b) in zip(tckpt._flatten(st), tckpt._flatten(st2)):
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), k
    jp = str(tmp_path / "jst.npz")
    jckpt.save_pytree(jp, jtr.init_state(_fcfg(jconfig)))
    assert sorted(_leaves(jp)) == sorted(_leaves(p))
    jst = jckpt.load_pytree(p, jtr.init_state(_fcfg(jconfig)))
    assert int(jst.frame_id) == 7
    np.testing.assert_array_equal(np.asarray(jst.velocity), np.arange(6))
    back = tckpt.load_pytree(jp, ttr.init_state(_fcfg(tconfig), device="cpu"))
    _assert_same_arrays({k: v.numpy() for k, v in tckpt._flatten(back)}, _leaves(jp))


def test_shape_mismatch_rejected(tmp_path):
    p = str(tmp_path / "st.npz")
    tckpt.save_pytree(p, ttr.init_state(_fcfg(tconfig), device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_pytree(p, ttr.init_state(_fcfg(tconfig, slots=32), device="cpu"))
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.load_pytree(p, {"fe": ttr.init_state(_fcfg(tconfig), device="cpu")})


# --------------------------------------------------------------- SlamSystem
def _slam_cfg(mod, scfg):
    """tests/test_checkpoint.py:46-53's configuration."""
    return mod.SystemConfig(
        frontend=mod.FrontendConfig(width=scfg.width, height=scfg.height, num_slots=64,
                                    pyramid_levels=3, per_cell=4, min_distance=12.0,
                                    margin=22),
        backend=mod.BackendConfig(window_size=4, max_landmarks=128, iters1=4, iters2=2))


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """tests/test_checkpoint.py's resume in both packages:
    the JAX system over frames 0..4, saved, loaded into a fresh one, frames
    5..9; the port the same (stepwise to the cut, then chunks) and straight
    through (chunks); and each package's file loaded into the other."""
    d = tmp_path_factory.mktemp("ckpt")
    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=6)
    frames = [scene.render(R, t)[:2] for (R, t) in orbit_trajectory(N_FRAMES, step=0.03)]
    cam_args = (scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline)
    size = dict(width=scfg.width, height=scfg.height)

    def jsys():
        return JaxSlam(_slam_cfg(jconfig, scfg), jcam.make(*cam_args, **size))

    def tsys():
        return trunner.SlamSystem(_slam_cfg(tconfig, scfg),
                                  tcam.make(*cam_args, **size, device="cpu"), device="cpu")

    def stack(fs):
        return np.stack([f[0] for f in fs]), np.stack([f[1] for f in fs])

    out = {"jp": str(d / "jax.npz"), "tp": str(d / "torch.npz")}
    ja = jsys()
    for f in frames[:CUT]:
        ja.process_frame(*f)
    jckpt.save_slam_system(out["jp"], ja)
    jb = jsys()
    jckpt.load_slam_system(out["jp"], jb)
    for f in frames[CUT:]:
        jb.process_frame(*f)
    mp = _with_jax_draws()
    try:
        ta = tsys()
        for f in frames[:CUT]:
            ta.process_frame(*f)
        tckpt.save_slam_system(out["tp"], ta)
        tb = tsys()
        tckpt.load_slam_system(out["tp"], tb)
        tb.process_frames(*stack(frames[CUT:]))
        tfull = tsys()
        tfull.process_frames(*stack(frames[:CUT]))
        tfull.process_frames(*stack(frames[CUT:]))
        tj = tsys()                         # the JAX file into the port
        tckpt.load_slam_system(out["jp"], tj)
    finally:
        mp.undo()
    jt = jsys()                             # the port's file into the JAX package
    jckpt.load_slam_system(out["tp"], jt)
    out.update(ja=ja, jb=jb, ta=ta, tb=tb, tfull=tfull, tj=tj, jt=jt)
    return out


def _state_arrays(slam):
    return {"fe": tckpt._flatten(slam.fe_state), "ba": tckpt._flatten(slam.ba_state),
            "vio": tckpt._flatten(slam.vio_state)}


def test_slam_files_share_keys(resumed):
    jk, tk = set(_leaves(resumed["jp"])), set(_leaves(resumed["tp"]))
    assert tk - jk == {tckpt.GENERATOR_KEY}
    assert jk <= tk


def test_jax_checkpoint_loads_into_port(resumed):
    tj, ja, jf = resumed["tj"], resumed["ja"], _leaves(resumed["jp"])
    got = {f"{g}/{k}": v.numpy() for g, leaves in _state_arrays(tj).items()
           for k, v in leaves}
    _assert_same_arrays(got, jf, keys=got)
    assert tj._frames_processed == len(ja.trajectory) == CUT
    np.testing.assert_array_equal(tj.trajectory_cam_centers(), ja.trajectory_cam_centers())


def test_port_checkpoint_loads_into_jax(resumed):
    jt, ta = resumed["jt"], resumed["ta"]
    want = {f"{g}/{k}": v.numpy() for g, leaves in _state_arrays(ta).items()
            for k, v in leaves}
    jckpt.save_pytree(resumed["jp"] + ".again.npz",
                      {"fe": jt.fe_state, "ba": jt.ba_state, "vio": jt.vio_state})
    _assert_same_arrays(want, _leaves(resumed["jp"] + ".again.npz"), keys=want)
    assert jt._frames_processed == CUT
    np.testing.assert_array_equal(jt.trajectory_cam_centers(), ta.trajectory_cam_centers())


def test_resume_continues(resumed):
    """tests/test_checkpoint.py:44-80's resume on the port: against its own
    straight-through run (5e-3 m) and the JAX resumed run (2e-4 m)."""
    tb, tfull, jb = resumed["tb"], resumed["tfull"], resumed["jb"]
    C = tb.trajectory_cam_centers()
    assert C.shape == (N_FRAMES, 3)
    np.testing.assert_allclose(C, tfull.trajectory_cam_centers(), atol=5e-3, rtol=0)
    np.testing.assert_allclose(C, jb.trajectory_cam_centers(), atol=2e-4, rtol=0)
    assert int(tb.fe_state.frame_id) == N_FRAMES


def test_generator_restored(resumed, tmp_path):
    """The port's draws continue from the saved generator state."""
    ta, tp = resumed["ta"], resumed["tp"]
    fresh = trunner.SlamSystem(ta.cfg, ta.cam, device="cpu", seed=99)
    tckpt.load_slam_system(tp, fresh)
    saved = _leaves(tp)[tckpt.GENERATOR_KEY]
    np.testing.assert_array_equal(fresh.generator.get_state().numpy(), saved)


# --------------------------------------------------------------- LoopCloser
def _loop_closers():
    """tests/test_checkpoint.py:83-121's loop node, in both packages."""
    import jax.numpy as jnp

    from flvis_tpu.geometry import se3 as jse3, so3 as jso3
    from flvis_tpu.loop.loop_closing import LoopCloser as JLC, LoopClosure as JLCl
    from flvis_tpu_torch.geometry import se3 as tse3
    from flvis_tpu_torch.loop.loop_closing import LoopCloser as TLC, LoopClosure as TLCl

    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                       baseline=0.12)
    scene = PlanarScene(scfg, plane_depth=8.0, seed=9)
    args = (scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline)
    kw = dict(max_keyframes=32, num_orb_features=128, vocab_words=64, kf_start=4, kf_dist=3,
              kf_max_dist=32, nkf_closest=1, min_score=0.0)
    jl = JLC(jconfig.LoopConfig(**kw), jcam.make(*args, width=256, height=192))
    tl = TLC(tconfig.LoopConfig(**kw), tcam.make(*args, width=256, height=192, device="cpu"),
             device="cpu")
    for k in range(10):
        img_l, img_r, _ = scene.render(np.eye(3), np.asarray([0.04 * k, 0, 0]))
        jl.add_keyframe(img_l, img_r, jse3.SE3(jso3.identity(),
                                               jnp.asarray([0.04 * k, 0.0, 0.0])), frame_id=k)
        tl.add_keyframe(img_l, img_r, tse3.SE3(torch.tensor([1.0, 0, 0, 0]),
                                               torch.tensor([0.04 * k, 0.0, 0.0])), frame_id=k)
    jl.T_map_odom = jse3.SE3(jso3.identity(), jnp.asarray([0.0, 0.1, 0.0]))
    tl.T_map_odom = tse3.SE3(torch.tensor([1.0, 0, 0, 0]), torch.tensor([0.0, 0.1, 0.0]))
    q, t = np.asarray([0.9, 0.1, 0.0, 0.0], np.float32), np.asarray([0.5, 0, 0], np.float32)
    q /= np.linalg.norm(q)
    jl.closures.append(JLCl(2, 8, 40, jse3.SE3(q, t)))
    tl.closures.append(TLCl(2, 8, 40, tse3.SE3(torch.as_tensor(q), torch.as_tensor(t))))
    return jl, tl, JLC, TLC, kw, args


def test_loop_closer_roundtrip_across(tmp_path):
    """A LoopCloser written by each package loads into the other (and into
    its own): the same count, database, features, poses, closures and
    drift; the restored port closer scores its database (diagonal 1)."""
    jl, tl, JLC, TLC, kw, args = _loop_closers()
    jp, tp = str(tmp_path / "jl.npz"), str(tmp_path / "tl.npz")
    jckpt.save_loop_closer(jp, jl)
    tckpt.save_loop_closer(tp, tl)
    assert sorted(_leaves(jp)) == sorted(_leaves(tp))
    for name, v in _leaves(tp).items():
        assert v.dtype == _leaves(jp)[name].dtype, name
    cam = dict(width=256, height=192)
    for path, src in ((jp, jl), (tp, tl)):
        t2 = TLC(tconfig.LoopConfig(**kw), tcam.make(*args, **cam, device="cpu"), device="cpu")
        tckpt.load_loop_closer(path, t2)
        j2 = JLC(jconfig.LoopConfig(**kw), jcam.make(*args, **cam))
        jckpt.load_loop_closer(path, j2)
        n = src.count
        assert t2.count == j2.count == n == 10
        for a in ("bow_db", "kf_uv", "kf_kp_valid", "kf_pc", "kf_pc_valid", "kf_q_odom",
                  "kf_t_odom", "kf_q", "kf_t"):
            want = np.asarray(getattr(src, a)[:n])
            np.testing.assert_array_equal(getattr(t2, a)[:n].numpy(), want, err_msg=a)
            np.testing.assert_array_equal(np.asarray(getattr(j2, a)[:n]), want, err_msg=a)
        want_desc = np.asarray(src.kf_desc[:n]).view(np.uint32)
        np.testing.assert_array_equal(t2.kf_desc[:n].numpy().view(np.uint32), want_desc)
        np.testing.assert_array_equal(np.asarray(j2.kf_desc[:n]), want_desc)
        np.testing.assert_array_equal(t2.kf_frame_id[:n], src.kf_frame_id[:n])
        for lc in (t2, j2):
            np.testing.assert_allclose(np.asarray(lc.T_map_odom.t), [0.0, 0.1, 0.0], atol=1e-7)
            assert [(c.kf_i, c.kf_j, c.num_inliers) for c in lc.closures] == [(2, 8, 40)]
            np.testing.assert_array_equal(np.asarray(lc.closures[0].T_ij.q),
                                          np.asarray(src.closures[0].T_ij.q))
            np.testing.assert_array_equal(np.asarray(lc.vocab.words_pm1),
                                          np.asarray(src.vocab.words_pm1))
        S = t2.sim_matrix()
        assert S.shape == (10, 10)
        np.testing.assert_allclose(np.diag(S), 1.0, atol=1e-5)


# ------------------------------------------------------------- MultiSeqSlam
def _ms_cfg(mod, scfg):
    """tests/test_checkpoint.py:128-144's configuration."""
    return mod.SystemConfig(
        frontend=mod.FrontendConfig(width=scfg.width, height=scfg.height, num_slots=128,
                                    pyramid_levels=3, per_cell=8, min_distance=12.0,
                                    margin=22, kf_min_trans=0.04, pnp_fallback=False),
        backend=mod.BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4,
                                  pallas_schur=False),
        loop=mod.LoopConfig(max_keyframes=64, num_orb_features=128, vocab_words=128,
                            kf_start=10, kf_dist=8, kf_max_dist=64, nkf_closest=2,
                            min_pts=12, min_score=0.03, ratio_ransac=0.3,
                            seq_edge_successors=3))


def test_multiseq_roundtrip_across(tmp_path):
    """tests/test_checkpoint.py:124-183 at S = 2 on the port: the resumed
    system continues as the uninterrupted one (1e-5 m, the reference test's
    tolerance); the port's file, with its per-sequence states stacked on a
    leading S axis, loads into the JAX MultiSeqSlam, whose file loads back
    into a fresh port system with the same arrays."""
    from flvis_tpu.parallel.multiseq_loop import MultiSeqSlam as JMS
    from flvis_tpu_torch.parallel.multiseq_loop import MultiSeqSlam as TMS

    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                       baseline=0.12)
    scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
    args = (scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline)
    size = dict(width=scfg.width, height=scfg.height)
    n, S = 16, 2
    frames = [scene.render(np.eye(3), -np.asarray([x, 0.0, 0.0]))
              for x in np.linspace(0, 0.6, n)]
    i0 = np.stack([f[0] for f in frames])
    i1 = np.stack([f[1] for f in frames])

    def bc(a):
        return np.broadcast_to(a, (S,) + a.shape)

    def tms():
        return TMS(_ms_cfg(tconfig, scfg), tcam.make(*args, **size, device="cpu"),
                   num_seqs=S, use_loop=True, device="cpu")

    full = tms()
    for c0 in range(0, n, 8):
        full.process_chunk(bc(i0[c0:c0 + 8]), bc(i1[c0:c0 + 8]))
    full.flush()
    a = tms()
    a.process_chunk(bc(i0[:8]), bc(i1[:8]))
    p = str(tmp_path / "ms.npz")
    tckpt.save_multiseq(p, a)
    b = tms()
    tckpt.load_multiseq(p, b)
    assert b._frames == 8
    b.process_chunk(bc(i0[8:]), bc(i1[8:]))
    b.flush()
    for s in range(S):
        t_full = np.asarray([t for (_, _, _, t) in full.trajectories[s]])
        t_res = np.asarray([t for (_, _, _, t) in b.trajectories[s]])
        np.testing.assert_allclose(t_res, t_full, atol=1e-5)
        assert b.loopers[s].count == full.loopers[s].count

    j = JMS(_ms_cfg(jconfig, scfg), jcam.make(*args, **size), num_seqs=S, use_loop=True)
    jckpt.load_multiseq(p, j)
    assert j._frames == 8
    jp = str(tmp_path / "jms.npz")
    jckpt.save_multiseq(jp, j)
    tk, jk = set(_leaves(p)), set(_leaves(jp))
    assert tk - jk == {tckpt.GENERATORS_KEY}
    _assert_same_arrays(_leaves(jp), _leaves(p), keys=jk)
    c = tms()
    tckpt.load_multiseq(jp, c)
    assert c._frames == 8
    for s in range(S):
        for x, y in zip(tckpt._flatten((c.fe[s], c.ba[s], c.corr[s])),
                        tckpt._flatten((a.fe[s], a.ba[s], a.corr[s]))):
            assert torch.equal(x[1], y[1]), x[0]
        np.testing.assert_array_equal(np.asarray([r[3] for r in c.trajectories[s]]),
                                      np.asarray([r[3] for r in a.trajectories[s]]))
        la, lc = a.loopers[s], c.loopers[s]
        assert lc.count == la.count
        assert torch.equal(lc.bow_db[:la.count], la.bow_db[:la.count])
        assert torch.equal(lc.kf_desc[:la.count], la.kf_desc[:la.count])
