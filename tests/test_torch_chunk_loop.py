"""The chunked replay's deferred loop node: flvis_tpu_torch's
SlamSystem.process_frames (+ flush_loop) and LoopCloser.add_keyframes_batch
against the JAX package's.

In the reference's chunked replay the loop node ingests a whole chunk's
keyframes at the chunk's end, decides their candidate gate one chunk later
and accepts their verification one chunk after that
(flvis_tpu/pipeline/runner.py:487-556).  The stepwise path
(process_frame) ingests, gates and verifies each keyframe at once.  The
scene is the 24-frame out-and-back of tests/test_multiseq_loop.py:34-60;
the reference's draws are handed to the port (tracker draws per frame,
bow.train's centroids, the verification's RANSAC scores).

Tolerances: keyframe counts and closure pairs exactly; trajectory and
T_map_odom.t within 1e-3 (float rounding of the two frameworks compounds
through BA feedback and the PGO); the batched ingest's stores, BoW rows and
gate rows within 1e-5, validity exactly, descriptors up to 16 near-tie bits
over the 12 keyframes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flvis_tpu.config as jconfig
import flvis_tpu_torch.config as tconfig
from flvis_tpu.frontend import tracker as jtr
from flvis_tpu.geometry import camera as jcam, se3 as jse3, so3 as jso3
from flvis_tpu.io.synthetic import PlanarScene, SceneConfig
from flvis_tpu.loop import loop_closing as jlc
from flvis_tpu.ops import stereo as jstereo
from flvis_tpu.pipeline.runner import SlamSystem as JaxSlam
from flvis_tpu_torch.frontend import tracker as ttr
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.loop import bow as tbow, loop_closing as tlc
from flvis_tpu_torch.pipeline import runner as trunner

torch.set_num_threads(1)
SCFG = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                   baseline=0.12)
N = 24
CHUNK = 8


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


CAM_ARGS = (SCFG.fx, SCFG.fy, SCFG.cx, SCFG.cy, SCFG.baseline)


def _jax_draws(mp):
    """Route the port's random draws through the reference's jax.random
    calls: the tracker's per-frame key fold_in(PRNGKey(7), frame_id)
    (tracker.py:515-516), bow.train's jax.random.choice and the
    verification's PRNGKey(i·7919 + j)."""
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


def _jax_kernel_sweep(mp):
    """Run the JAX package's loop ingest through its Pallas sweep kernel (in
    interpret mode here), whose float32 semantics the port follows; on a
    CPU backend the package otherwise takes its bf16 XLA sweep."""
    mp.setattr(jstereo, "disparity_sweep",
               functools.partial(jstereo.disparity_sweep, use_kernel=True))
    jax.clear_caches()


def _pairs(lc):
    return [(c.kf_i, c.kf_j) for c in lc.closures]


@pytest.fixture(scope="module")
def scene():
    sc = PlanarScene(SCFG, plane_depth=8.0, seed=11)
    xs = list(np.linspace(0, 0.9, N // 2)) + list(np.linspace(0.9, 0.02, N - N // 2))
    frames = [sc.render(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


@pytest.fixture(scope="module")
def runs(scene):
    """The JAX package's chunked run, and the port's chunked, pipelined and
    stepwise runs (the port's process_frames ran the loop node stepwise
    before it took the reference's chunk semantics: process_frame keeps
    that behaviour, so its run is the port's result before the fix)."""
    i0, i1 = scene
    mp = pytest.MonkeyPatch()
    try:
        _jax_kernel_sweep(mp)
        jsys = JaxSlam(_cfg(jconfig), jcam.make(*CAM_ARGS, width=SCFG.width,
                                                height=SCFG.height), use_loop=True)
        seen = {"jax": [], "chunked": [], "stepwise": []}
        for c0 in range(0, N, CHUNK):
            jsys.process_frames(i0[c0:c0 + CHUNK], i1[c0:c0 + CHUNK])
            seen["jax"].append(_pairs(jsys.loop_closer))
        jsys.flush_loop()
        _jax_draws(mp)

        def port(**kw):
            return trunner.SlamSystem(
                _cfg(tconfig), tcam.make(*CAM_ARGS, width=SCFG.width, height=SCFG.height,
                                         device="cpu"), device="cpu", use_loop=True, **kw)

        chunked, piped = port(), port(pipelined=True)
        piped_rets = []
        for c0 in range(0, N, CHUNK):
            chunked.process_frames(i0[c0:c0 + CHUNK], i1[c0:c0 + CHUNK])
            seen["chunked"].append(_pairs(chunked.loop_closer))
            piped_rets.append(piped.process_frames(i0[c0:c0 + CHUNK], i1[c0:c0 + CHUNK]))
        chunked.flush_loop()
        piped_rets.append(piped.flush())
        stepwise = port()
        for k in range(N):
            stepwise.process_frame(i0[k], i1[k])
            if (k + 1) % CHUNK == 0:
                seen["stepwise"].append(_pairs(stepwise.loop_closer))
    finally:
        mp.undo()
        jax.clear_caches()
    return jsys, chunked, piped, piped_rets, stepwise, seen


def test_stepwise_loop_node_differs_from_chunked(runs):
    """Before the fix the port's process_frames ran the loop node stepwise:
    its closures were accepted at once, so after each chunk it held other
    closures than the reference's chunked replay, whose gate and
    verification resolve one chunk late each.  After the fix the port
    holds the reference's closures at every chunk's end."""
    seen = runs[-1]
    assert seen["stepwise"] != seen["jax"]
    assert seen["chunked"] == seen["jax"]
    assert any(len(a) > len(b) for a, b in zip(seen["stepwise"], seen["jax"]))


def test_chunked_replay_matches_reference(runs):
    jsys, chunked = runs[:2]
    jl, tl = jsys.loop_closer, chunked.loop_closer
    assert len(chunked.keyframes) == len(jsys.keyframes) == tl.count == jl.count
    assert _pairs(tl) == _pairs(jl) and len(_pairs(tl)) >= 1
    np.testing.assert_allclose(np.asarray([e[3] for e in chunked.trajectory]),
                               np.asarray([e[3] for e in jsys.trajectory]), atol=1e-3)
    np.testing.assert_allclose(tl.T_map_odom.t.numpy(), np.asarray(jl.T_map_odom.t),
                               atol=1e-3)
    np.testing.assert_allclose(chunked.trajectory_cam_centers(loop_corrected=True),
                               jsys.trajectory_cam_centers(loop_corrected=True), atol=1e-3)


def test_pipelined_returns_one_chunk_late(runs):
    """pipelined=True: None first, then the previous chunk's outputs, and the
    same run as the synchronous one once flush() has drained it."""
    _, chunked, piped, rets = runs[:4]
    assert rets[0] is None and all(r is not None for r in rets[1:])
    st = np.concatenate([r.status for r in rets[1:]])
    assert st.shape == (N,) and (st[1:] == 1).all()
    assert _pairs(piped.loop_closer) == _pairs(chunked.loop_closer)
    for a, b in zip(piped.trajectory, chunked.trajectory):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[3], b[3])
    np.testing.assert_array_equal(piped.loop_closer.T_map_odom.t.numpy(),
                                  chunked.loop_closer.T_map_odom.t.numpy())


@pytest.fixture(scope="module")
def batch_ingest():
    """tests/test_loop_closing.py:161-231: a vocabulary trained stepwise by
    the JAX package, then two chunks (7 + 5 keyframes) through both
    add_keyframes_batch."""
    scfg = SCFG
    sc = PlanarScene(scfg, plane_depth=8.0, seed=21)
    kw = dict(max_keyframes=32, num_orb_features=128, vocab_words=64, kf_start=4,
              kf_dist=2, kf_max_dist=32, nkf_closest=1, min_score=0.0)
    jc = jcam.make(*CAM_ARGS, width=scfg.width, height=scfg.height)
    frames = []
    lc_tr = jlc.LoopCloser(jconfig.LoopConfig(**kw), jc)
    for k in range(12):
        t = np.asarray([0.05 * k, 0.0, 0.0], np.float32)
        img_l, img_r, _ = sc.render(np.eye(3), t)
        frames.append((img_l, img_r, t))
        if k < 9:
            lc_tr.add_keyframe(img_l, img_r, jse3.SE3(jso3.identity(), jnp.asarray(t)),
                               frame_id=k)
    jv = lc_tr.vocab
    mp = pytest.MonkeyPatch()
    _jax_kernel_sweep(mp)
    jl = jlc.LoopCloser(jconfig.LoopConfig(**kw), jc, vocab=jv)
    tl = tlc.LoopCloser(tconfig.LoopConfig(**kw),
                        tcam.make(*CAM_ARGS, width=scfg.width, height=scfg.height,
                                  device="cpu"),
                        vocab=tbow.Vocabulary(torch.as_tensor(np.asarray(jv.words_pm1)),
                                              torch.as_tensor(np.asarray(jv.idf))),
                        device="cpu")
    for lo, hi in ((0, 7), (7, 12)):
        il = np.stack([frames[i][0] for i in range(lo, hi)])
        ir = np.stack([frames[i][1] for i in range(lo, hi)])
        q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (hi - lo, 1))
        t = np.stack([frames[i][2] for i in range(lo, hi)])
        for lc in (jl, tl):
            assert lc.add_keyframes_batch(il, ir, list(range(hi - lo)), q, t,
                                          list(range(lo, hi))) == list(range(lo, hi))
    mp.undo()
    jax.clear_caches()
    return jl, tl


@pytest.mark.parametrize("table", ["kf_desc", "kf_kp_valid", "kf_pc_valid", "kf_uv", "kf_pc",
                                   "kf_q_odom", "kf_t_odom", "kf_q", "kf_t", "bow_db"])
def test_batch_ingest_stores_match(batch_ingest, table):
    jl, tl = batch_ingest
    assert jl.count == tl.count == 12
    t_arr, j_arr = getattr(tl, table).numpy()[:12], np.asarray(getattr(jl, table))[:12]
    if table == "kf_desc":
        # A near-tie BRIEF comparison may flip between the two frameworks
        # (tests/test_torch_orb_stereo.py; the reference's own batch-vs-
        # stepwise test allows 16 bits, tests/test_loop_closing.py:205-212).
        xor = np.bitwise_xor(t_arr, j_arr.view(np.int32))
        assert int(np.unpackbits(xor.view(np.uint8)).sum()) <= 16
    elif t_arr.dtype == np.bool_:
        np.testing.assert_array_equal(t_arr, j_arr)
    else:
        np.testing.assert_allclose(t_arr, j_arr, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tl.kf_frame_id, jl.kf_frame_id)


def test_batch_gate_rows_match(batch_ingest, monkeypatch):
    jl, tl = batch_ingest
    _jax_draws(monkeypatch)
    ks = list(range(12))
    jp, tp = jl.gate_candidates(ks), tl.gate_candidates(ks)
    assert tp[1] == jp[1] and list(tp[2]) == list(jp[2]) and list(tp[3]) == list(jp[3])
    m = len(tp[1])
    np.testing.assert_allclose(tl.pending_rows(tp).numpy(),
                               np.asarray(jl.pending_rows(jp))[:m], atol=1e-5, rtol=0)
    assert _pairs_of(tl.decide_loops(tp)) == _pairs_of(jl.decide_loops(jp))


def _pairs_of(closures):
    return [(c.kf_i, c.kf_j) for c in closures]
