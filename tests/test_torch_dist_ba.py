"""flvis_tpu_torch.parallel.dist_ba — the landmark-sharded window BA over 4
gloo ranks on the CPU — against flvis_tpu.parallel.dist_ba on a 4-device
`lm` mesh (the 8 virtual CPU devices) and against the port's single-device
path, on the inputs of tests/test_parallel.py:350-414:

  - optimize_sharded on a 5-keyframe window of 60 landmarks in 128 slots
    (tests/test_parallel.py:350-370);
  - chunk_fused_sharded over 6 frames of a MultiPlaneScene orbit at the
    entry configuration (tests/test_parallel.py:373-414), the reference's
    draws handed to the port.

Tolerances are JAX's own (t 5e-4, landmarks 5e-3): a sharded sum is
reordered.  The ranks' replicated outputs must be bit-equal to each other,
and schur_step_plain without a reduction bit-equal to the step with an
identity one.  The ranks are spawned once for the file (a module
fixture); this module imports JAX only inside its fixtures, so the ranks
(which import it to find their function) stay free of it."""

import numpy as np
import pytest
import torch

import flvis_tpu_torch.config as tconfig
from flvis_tpu_torch import interop
from flvis_tpu_torch.backend import window_ba as twba
from flvis_tpu_torch.frontend import tracker as ttr
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.ops.kernels import schur
from flvis_tpu_torch.parallel import dist_ba, mesh as mesh_m, multihost
from flvis_tpu_torch.pipeline import runner as trunner

torch.set_num_threads(1)
N_RANKS = 4
BA_KW = dict(window_size=5, max_landmarks=128, min_views=3, iters1=6, iters2=4)
CAM_BA = (400.0, 400.0, 256.0, 192.0, 0.2, 512, 384)
FE_KW = dict(width=256, height=192, num_slots=64, pyramid_levels=3, per_cell=4,
             min_distance=10.0, margin=12, lk_radius=7, ransac_hypotheses=32,
             kf_bootstrap_every=2)
CH_KW = dict(window_size=4, max_landmarks=128, min_views=2, iters1=4, iters2=3,
             pallas_schur=False)
CAM_CH = (200.0, 200.0, 128.0, 96.0, 0.12, 256, 192)
T = 6
TOL_T, TOL_LM = 5e-4, 5e-3          # tests/test_parallel.py:353-356,398-414


def _cam(args):
    return tcam.make(*args[:5], width=args[5], height=args[6], device="cpu")


def _window(d, cfg):
    return interop.from_numpy(d, twba.empty(cfg, device="cpu"), interop.to_torch("cpu"))


def _rank(window_d, imgs0, imgs1, draws):
    """Each rank: optimize_sharded on its share of the window, then the
    sharded chunk; returns numpy readings."""
    mesh = dist_ba.make_lm_mesh("cpu")
    cfg = tconfig.BackendConfig(**BA_KW)
    poses, lm, cost = dist_ba.optimize_sharded(
        cfg, mesh, _cam(CAM_BA), dist_ba.shard_window_state(mesh, _window(window_d, cfg)))
    fcfg, bcfg = tconfig.FrontendConfig(**FE_KW), tconfig.BackendConfig(**CH_KW)
    _, ba, _, (outs, costs) = dist_ba.chunk_fused_sharded(
        fcfg, bcfg, mesh, _cam(CAM_CH), ttr.init_state(fcfg, device="cpu"),
        dist_ba.shard_window_state(mesh, twba.empty(bcfg, device="cpu")),
        dist_ba.shard_correction(mesh, twba.null_correction(bcfg, device="cpu")),
        torch.as_tensor(imgs0), torch.as_tensor(imgs1), draws=draws)
    return {"q": poses.q.numpy(), "t": poses.t.numpy(), "lm": lm.numpy(),
            "cost": cost.numpy(), "outs": interop.to_numpy(outs), "costs": costs.numpy(),
            "ba": interop.to_numpy(ba)}


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp

    import flvis_tpu.config as jconfig
    import tests.test_window_ba as twb
    from flvis_tpu.backend import window_ba as jwba
    from flvis_tpu.frontend import tracker as jtr
    from flvis_tpu.geometry import camera as jcam
    from flvis_tpu.io.synthetic import MultiPlaneScene, SceneConfig, orbit_trajectory
    from flvis_tpu.parallel import dist_ba as jdist
    from tests.test_torch_fused_step import jax_draws

    # The window of tests/test_parallel.py:350-359, built by both packages.
    rng = np.random.default_rng(0)
    jcfg, tcfg = jconfig.BackendConfig(**BA_KW), tconfig.BackendConfig(**BA_KW)
    pts = twb.make_world(rng)
    js, ts = jwba.empty(jcfg), twba.empty(tcfg, device="cpu")
    pkt_like = twba.KeyframePacket(*([None] * 9))
    for i in range(5):
        p = twb.packet(i, pts, rng, pose_noise=0.0 if i == 0 else 0.02, pw_noise=0.1)
        js = jwba.add_keyframe(jcfg, js, p)
        ts = twba.add_keyframe(tcfg, ts, interop.from_numpy(interop.to_numpy(p), pkt_like,
                                                            interop.to_torch("cpu")))
    mesh = jdist.make_lm_mesh(N_RANKS)
    jposes, jlm, _ = jdist.optimize_sharded(jcfg, mesh, twb.CAM,
                                            jdist.shard_window_state(mesh, js))
    single = twba.optimize(tcfg, _cam(CAM_BA), ts)

    # The chunk of tests/test_parallel.py:373-414.
    jf = jconfig.FrontendConfig(**FE_KW)
    jb = jconfig.BackendConfig(**CH_KW)
    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                       baseline=0.12)
    frames = [MultiPlaneScene(scfg, seed=0).render(R, t)
              for (R, t) in orbit_trajectory(T, step=0.04)]
    imgs0 = np.stack([f[0] for f in frames]).astype(np.float32)
    imgs1 = np.stack([f[1] for f in frames]).astype(np.float32)
    jcam1 = jcam.make(*CAM_CH[:5], width=256, height=192)
    _, jba, _, (jouts, _) = jdist.chunk_fused_sharded(
        jf, jb, mesh, jcam1, jtr.init_state(jf),
        jdist.shard_window_state(mesh, jwba.empty(jb)),
        jdist.shard_correction(mesh, jwba.null_correction(jb)),
        jnp.asarray(imgs0), jnp.asarray(imgs1))
    jouts = jax.tree.map(np.asarray, jouts)
    draws = jax_draws(jf, jouts.status)

    # The port's single-device chunk on the same draws.
    fcfg, bcfg = tconfig.FrontendConfig(**FE_KW), tconfig.BackendConfig(**CH_KW)
    cam = _cam(CAM_CH)
    null = twba.null_correction(bcfg, device="cpu")
    step = lambda c, x, d: trunner._fused_frame_step(fcfg, bcfg, cam, null, c, x, d)
    (_, sba, _), packed, _ = trunner.run_chunk_eager(
        step, (ttr.init_state(fcfg, device="cpu"), twba.empty(bcfg, device="cpu"), null),
        (torch.as_tensor(imgs0), torch.as_tensor(imgs1)), lambda i: draws[i])

    ranks = multihost.spawn(_rank, N_RANKS, (interop.to_numpy(ts), imgs0, imgs1, draws),
                            device_type="cpu", threads=1)
    return dict(jax=(jposes, jlm, jouts, jba), single=(single, sba, packed), ts=ts,
                ranks=ranks)


def _live(ids, valid, pw):
    return dict(zip(ids[valid].tolist(), pw[valid]))


def test_reduce_none_keeps_the_single_device_step(runs):
    """schur_step_plain's reduction hook: None (one device) is bit-equal to
    an identity reduction, and optimize over a mesh of one rank to the
    unmeshed optimize."""
    ts, cfg, cam = runs["ts"], tconfig.BackendConfig(**BA_KW), _cam(CAM_BA)
    poses = ts.poses()
    w_mask = ts.obs_valid & ts.kf_valid[:, None] & ts.lm_valid[None, :]
    fixed = torch.arange(5) == 0
    consts = twba._schur_consts(cam, (ts.obs_uv, ts.obs_ur, ts.obs_ur_valid & w_mask),
                                w_mask, fixed)
    R = twba.so3.to_matrix(poses.q).reshape(5, 9)
    args = (R, poses.t, ts.lm_pw.T.contiguous(), *consts, torch.tensor(1e-3), 1.0)
    a = schur.schur_step_plain(*args)
    b = schur.schur_step_plain(*args, reduce=lambda x: x)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    one = mesh_m.Mesh("lm", 1, 0, torch.device("cpu"))
    r0, r1 = twba.optimize(cfg, cam, ts), twba.optimize(cfg, cam, ts, mesh=one)
    for x, y in zip(interop.to_numpy(r0.state).values(), interop.to_numpy(r1.state).values()):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(r0.cost, r1.cost)


def test_optimize_sharded_matches_jax_and_single_device(runs):
    jposes, jlm, _, _ = runs["jax"]
    single = runs["single"][0]
    lm = np.concatenate([r["lm"] for r in runs["ranks"]])
    t = runs["ranks"][0]["t"]
    live = runs["ts"].lm_valid.numpy()
    np.testing.assert_allclose(t, np.asarray(jposes.t), atol=TOL_T, rtol=0)
    np.testing.assert_allclose(lm[live], np.asarray(jlm)[live], atol=TOL_LM, rtol=0)
    np.testing.assert_allclose(t, single.state.kf_t.numpy(), atol=TOL_T, rtol=0)
    np.testing.assert_allclose(lm[live], single.state.lm_pw.numpy()[live], atol=TOL_LM, rtol=0)


def test_chunk_fused_sharded_matches_jax_and_single_device(runs):
    _, _, jouts, jba = runs["jax"]
    _, sba, packed = runs["single"]
    r0 = runs["ranks"][0]
    single = trunner._unpack_outputs(packed.numpy())
    for ref_status, ref_kf, ref_t in ((jouts.status, jouts.is_keyframe, jouts.T_c_w.t),
                                      (single.status, single.is_keyframe, single.T_c_w.t)):
        np.testing.assert_array_equal(r0["outs"]["status"], ref_status)
        np.testing.assert_array_equal(r0["outs"]["is_keyframe"], ref_kf)
        np.testing.assert_allclose(r0["outs"]["T_c_w"]["t"], ref_t, atol=TOL_T, rtol=0)
    assert r0["outs"]["is_keyframe"].any()
    cat = {k: np.concatenate([r["ba"][k] for r in runs["ranks"]])
           for k in ("lm_id", "lm_valid", "lm_pw")}
    got = _live(cat["lm_id"], cat["lm_valid"], cat["lm_pw"])
    for ids, valid, pw in ((np.asarray(jba.lm_id), np.asarray(jba.lm_valid),
                            np.asarray(jba.lm_pw)),
                           (sba.lm_id.numpy(), sba.lm_valid.numpy(), sba.lm_pw.numpy())):
        ref = _live(ids, valid, pw)
        assert set(got) == set(ref) and len(ref) > 0
        assert max(np.abs(got[i] - ref[i]).max() for i in ref) < TOL_LM
    # Each landmark lives on the rank that owns its id.
    for r, rank in enumerate(runs["ranks"]):
        ids = rank["ba"]["lm_id"][rank["ba"]["lm_valid"]]
        assert np.all(ids % N_RANKS == r)


def test_ranks_replicate_bit_for_bit(runs):
    r0 = runs["ranks"][0]
    for r in runs["ranks"][1:]:
        for k in ("q", "t", "cost", "costs"):
            np.testing.assert_array_equal(r[k], r0[k], err_msg=k)
        for k in ("status", "is_keyframe", "num_inliers"):
            np.testing.assert_array_equal(r["outs"][k], r0["outs"][k], err_msg=k)
        np.testing.assert_array_equal(r["outs"]["T_c_w"]["t"], r0["outs"]["T_c_w"]["t"])
        np.testing.assert_array_equal(r["ba"]["kf_t"], r0["ba"]["kf_t"])
