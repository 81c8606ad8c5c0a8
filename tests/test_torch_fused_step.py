"""The fused frame step of the port (flvis_tpu_torch.pipeline.runner
._fused_frame_step — what SlamSystem captures as one CUDA graph on the card
and runs eagerly here) against the reference's one-program chunk
(flvis_tpu.pipeline.runner._chunk_fused), at the entry configuration
(__graft_entry__._small_cfg: 256×192, 64 slots) over a sequence whose two
blank frames drive the tracker to FAIL and back through re-initialisation
with a backend reset.  Also: utils/control.cond and while_loop, window
BA's LM loop (a while_loop on `done`), the sites a captured step holds,
and the fused steps' freedom from host reads.

The port's step is handed the reference's draws of every frame
(jax.random.fold_in(PRNGKey(7), frame_id), split as tracker.py:515-516
splits it), so both make the same discrete decisions and differ by float
rounding.  Tolerances are those of tests/test_torch_runner.py: statuses,
keyframe, reset and correction-valid flags exactly; poses 2e-4 m / 2e-5;
BA costs 1e-3 relative; the final BA window's keyframe and landmark ids
exactly.  The JAX chunk is compiled once for the file (module fixture)."""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as entry
import flvis_tpu.config as jconfig
import flvis_tpu_torch.config as tconfig
from flvis_tpu.backend import window_ba as jwba
from flvis_tpu.frontend import tracker as jtr
from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory
from flvis_tpu.pipeline import runner as jrunner
from flvis_tpu_torch.backend import window_ba as twba
from flvis_tpu_torch.frontend import tracker as ttr
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.geometry import se3 as tse3
from flvis_tpu_torch.pipeline import runner as trunner
from flvis_tpu_torch.utils import control
from flvis_tpu_torch.utils.tree import tree_leaves, tree_map, tree_spec
from flvis_tpu_torch.vio import vimotion as tvim

torch.set_num_threads(1)
N_FRAMES = 12
BLANK = (5, 6)                  # escaped, then FAIL; frame 7 re-initialises
BCFG_KW = dict(window_size=5, max_landmarks=256, iters1=8, iters2=4)


def scene_config():
    jf = entry._small_cfg()
    return SceneConfig(width=jf.width, height=jf.height, fx=200.0, fy=200.0,
                       cx=jf.width / 2, cy=jf.height / 2, baseline=0.12)


def configs(**frontend):
    """(JAX frontend, JAX backend, port frontend, port backend): the entry
    frontend (with `frontend` overrides) and a 5-keyframe window."""
    jf = dataclasses.replace(entry._small_cfg(), **frontend)
    tf = tconfig.FrontendConfig(**{f.name: getattr(jf, f.name)
                                   for f in dataclasses.fields(jconfig.FrontendConfig)})
    return jf, jconfig.BackendConfig(**BCFG_KW), tf, tconfig.BackendConfig(**BCFG_KW)


def cameras(jf):
    jc = entry._camera(jf)
    tc = tcam.make(float(jc.fx), float(jc.fy), float(jc.cx), float(jc.cy),
                   float(jc.baseline), width=jf.width, height=jf.height, device="cpu")
    return jc, tc


def stereo_frames(seed=4, blank=BLANK):
    scene = PlanarScene(scene_config(), plane_depth=8.0, seed=seed)
    frames = [scene.render(R, t)[:2] for (R, t) in orbit_trajectory(N_FRAMES, step=0.03)]
    imgs0 = np.stack([f[0] for f in frames]).astype(np.float32)
    imgs1 = np.stack([f[1] for f in frames]).astype(np.float32)
    imgs0[list(blank)] = 0.0
    imgs1[list(blank)] = 0.0
    return imgs0, imgs1


def jax_draws(fcfg, statuses):
    """The reference's draws of each frame, given the JAX statuses (the
    state's status before frame i is frame i-1's output status)."""
    h, n = fcfg.ransac_hypotheses, fcfg.num_slots
    lo, hi = fcfg.dummy_depth_range
    before = [jtr.STATUS_UNINIT] + [int(s) for s in statuses[:-1]]
    out = []
    for i, st in enumerate(before):
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        if st == jtr.STATUS_TRACKING:
            k_r, k_d, k_p = jax.random.split(key, 3)
            arrs = (jax.random.uniform(k_r, (h, n)), jax.random.uniform(k_p, (h, n)),
                    jax.random.uniform(k_d, (n,), jnp.float32, lo, hi))
        else:
            arrs = (jnp.zeros((h, n)), jnp.zeros((h, n)),
                    jax.random.uniform(key, (n,), jnp.float32, lo, hi))
        out.append(ttr.Draws(*(torch.as_tensor(np.array(a)) for a in arrs)))
    return out


def assert_chunks_match(jys, jba, packed, tba, *, check_inliers=True):
    """The reference's stacked (outs, pkts, corrs, costs) and final window
    against the port's packed (T, 14) outputs and final window."""
    jouts, _, jcorrs, jcosts = jys
    got = trunner._unpack_outputs(packed.numpy())
    np.testing.assert_array_equal(got.status, np.asarray(jouts.status))
    np.testing.assert_array_equal(got.is_keyframe, np.asarray(jouts.is_keyframe))
    np.testing.assert_array_equal(got.reset_backend, np.asarray(jouts.reset_backend))
    if check_inliers:
        np.testing.assert_array_equal(got.num_inliers, np.asarray(jouts.num_inliers))
    np.testing.assert_allclose(got.T_c_w.t, np.asarray(jouts.T_c_w.t), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.T_c_w.q, np.asarray(jouts.T_c_w.q), atol=2e-5, rtol=0)
    np.testing.assert_allclose(packed[:, 12].numpy(), np.asarray(jcosts), rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(packed[:, 13].numpy() > 0.5, np.asarray(jcorrs.valid))
    np.testing.assert_array_equal(tba.kf_frame_id.numpy(), np.asarray(jba.kf_frame_id))
    np.testing.assert_array_equal(tba.lm_id.numpy(), np.asarray(jba.lm_id))


@pytest.fixture(scope="module")
def stereo_runs():
    jf, jb, tf, tb = configs()
    jc, tc = cameras(jf)
    imgs0, imgs1 = stereo_frames()
    _, jba, _, jys = jrunner._chunk_fused(jf, jb, jc, jtr.init_state(jf), jwba.empty(jb),
                                          jwba.null_correction(jb), jnp.asarray(imgs0),
                                          jnp.asarray(imgs1))
    draws = jax_draws(jf, np.asarray(jys[0].status))
    null = twba.null_correction(tb, device="cpu")
    step = functools.partial(trunner._fused_frame_step, tf, tb, tc, null)
    carry = (ttr.init_state(tf, device="cpu"), twba.empty(tb, device="cpu"), null)
    (_, tba, _), packed, _ = trunner.run_chunk_eager(
        step, carry, (torch.as_tensor(imgs0), torch.as_tensor(imgs1)), lambda i: draws[i])
    return jys, jba, packed, tba


def test_fused_step_matches_chunk_fused(stereo_runs):
    """Twelve frames through blank-frame FAIL, re-initialisation and the
    backend reset, against the reference's one-program chunk."""
    jys, jba, packed, tba = stereo_runs
    st = packed[:, 2].numpy().astype(int)
    assert st[BLANK[1]] == jtr.STATUS_FAIL and st[BLANK[1] + 1] == jtr.STATUS_TRACKING
    assert packed[BLANK[1] + 1, 1] > 0.5                 # the re-init resets the backend
    assert (packed[:, 13] > 0.5).sum() >= 1              # a valid BA correction fed back
    assert_chunks_match(jys, jba, packed, tba)


# --------------------------------------------------------------------- cond
def test_cond_picks_its_branch():
    """Eager: only the branch pred picks runs; under both_branches both run
    and pred still picks the result."""
    ran = []

    def t(x):
        ran.append("t")
        return x + 1, (x * 2,)

    def f(x):
        ran.append("f")
        return x - 1, (x * 3,)

    x = torch.arange(3.0)
    for pred, want, side in ((True, (x + 1, x * 2), "t"), (False, (x - 1, x * 3), "f")):
        ran.clear()
        a, (b,) = control.cond(torch.tensor(pred), t, f, (x,))
        assert ran == [side]
        assert torch.equal(a, want[0]) and torch.equal(b, want[1])
    with control.both_branches():
        ran.clear()
        a, (b,) = control.cond(torch.tensor(False), t, f, (x,))
    assert ran == ["t", "f"] and torch.equal(a, x - 1) and torch.equal(b, x * 3)


@pytest.mark.parametrize("other", ["shape", "dtype", "record", "leaf"])
def test_cond_refuses_different_trees(other):
    """Branches must return the same tree (records, non-tensor leaves,
    tensor shapes and dtypes), wherever both run; a pred must be a 0-d bool
    tensor."""
    x = torch.zeros(3)
    se3 = tse3.identity()
    alt = {"shape": lambda: (torch.zeros(4), se3, 1),
           "dtype": lambda: (torch.zeros(3, dtype=torch.float64), se3, 1),
           "record": lambda: (x, (se3.q, se3.t), 1),
           "leaf": lambda: (x, se3, 2)}[other]
    with control.both_branches(), pytest.raises(ValueError, match="different trees"):
        control.cond(torch.tensor(True), lambda: (x, se3, 1), alt)
    with pytest.raises(ValueError, match="0-d bool"):
        control.cond(torch.tensor([True]), lambda: x, lambda: x)


def test_while_loop_eager_both_branches_and_refusal():
    """Eagerly a Python loop on the predicate; under both_branches the
    body runs at least once, even where the first predicate is false, and
    the loop still returns the eager result; a body that changes the
    carry's tree is refused there.  branches is a list comprehension
    outside a capture."""
    def body(c):
        i, x = c
        return i + 1, x * 2 + i.to(x.dtype)

    def pred(c):
        return c[0] < 5

    x0 = torch.arange(3.0)
    i, x = 0, x0.clone()
    while i < 5:
        x, i = x * 2 + i, i + 1
    start = (torch.zeros((), dtype=torch.int32), x0)
    for ctx in (contextlib.nullcontext, control.both_branches):
        with ctx():
            got_i, got_x = control.while_loop(pred, body, start)
        assert int(got_i) == 5 and torch.equal(got_x, x)
    ran = []

    def counted(c):
        ran.append(1)
        return body(c)

    done = (torch.full((), 7, dtype=torch.int32), x0)
    with control.both_branches():
        got = control.while_loop(pred, counted, done)
    assert len(ran) == 1 and got is done
    assert control.while_loop(pred, counted, done) is done and len(ran) == 1

    def widens(c):
        return c[0] + 1, torch.cat([c[1], c[1]])

    with control.both_branches(), pytest.raises(ValueError, match="another tree"):
        control.while_loop(pred, widens, start)
    assert control.branches(lambda k: 2 * k, range(3)) == [0, 2, 4]


def test_capture_sites_take_rows_of_their_branch():
    """A capture's sites take rows of the taken counts in blocks of
    MAX_SITES — the step's own, then one block a branch — so S branches
    hold S x MAX_SITES sites; a full block refuses one more, naming its
    branch."""
    M = control.MAX_SITES
    cap = control._Capture(None, None, [[None] * 4] * 3)
    rows = [cap._site("top", "if")[0]]
    for b in (0, 1):
        cap.branch = b
        rows += [cap._site(f"branch {b}", "while")[0] for _ in range(M)]
    cap.branch = None
    rows.append(cap._site("top", "if")[0])
    assert rows == [0] + list(range(M, 3 * M)) + [1]
    assert [s["row"] for s in cap.sites] == rows
    cap.branch = 1
    with pytest.raises(RuntimeError, match="in branch 1"):
        cap._site("one too many", "if")


@pytest.mark.parametrize("kind", ["stereo", "vio"])
def test_captured_step_sites_do_not_grow_with_lm_steps(kind, monkeypatch):
    """The conds and loops a captured frame step holds — one site each,
    counted as the capture meets them: every call, with both sides of each
    cond run — are as many at 12 + 8 LM steps as at 120 + 10, because each
    LM phase is one while_loop (one WHILE node)."""
    names = []
    real_cond, real_while = control.cond, control.while_loop

    def cond(pred, t, f, operands=(), name="cond"):
        names.append(name)
        return real_cond(pred, t, f, operands, name)

    def while_loop(pred_fn, body_fn, carry, name="while"):
        names.append(name)
        return real_while(pred_fn, body_fn, carry, name)

    monkeypatch.setattr(control, "cond", cond)
    monkeypatch.setattr(control, "while_loop", while_loop)
    jf, _, tf, _ = configs()
    _, tc = cameras(jf)
    imgs0, imgs1 = stereo_frames(blank=())
    x = (torch.as_tensor(imgs0[0]), torch.as_tensor(imgs1[0]))
    imu = (torch.tensor(0.05), torch.zeros(16, 3), torch.zeros(16, 3),
           torch.linspace(0.0, 0.05, 16), torch.ones(16, dtype=torch.bool))
    sites = []
    for iters1, iters2 in ((12, 8), (120, 10)):
        tb = tconfig.BackendConfig(**{**BCFG_KW, "iters1": iters1, "iters2": iters2})
        null = twba.null_correction(tb, device="cpu")
        draws = ttr.make_draws(tf, torch.Generator().manual_seed(0), "cpu")
        fe, ba = ttr.init_state(tf, device="cpu"), twba.empty(tb, device="cpu")
        names.clear()
        with control.both_branches():
            if kind == "stereo":
                trunner._fused_frame_step(tf, tb, tc, null, (fe, ba, null), x, draws)
            else:
                vio = tvim.init_state(tconfig.VioConfig(), device="cpu")
                trunner._fused_vio_frame_step(tf, tb, tconfig.VioConfig(), tc, tse3.identity(),
                                              null, (fe, ba, vio, null), x + imu, draws)
        sites.append(list(names))
    assert sites[0] == sites[1]
    assert sites[0].count("lm_loop") == 2 and len(sites[0]) <= 8, sites[0]


def test_tree_walker_covers_tuples_and_lists():
    """utils/tree walks the records, NamedTuples, plain tuples and lists
    that cond and the captured step carry; tree_spec tells trees apart by
    structure, non-tensor leaves, shapes and dtypes."""
    se3 = tse3.identity()
    tree = (torch.zeros(2), [se3, None, 3], ttr.Draws(*(torch.ones(k) for k in (1, 2, 3))))
    leaves = tree_leaves(tree)
    assert [tuple(t.shape) for t in leaves] == [(2,), (4,), (3,), (1,), (2,), (3,)]
    doubled = tree_map(lambda t: 2 * t, tree)
    assert isinstance(doubled[1], list) and doubled[1][1:] == [None, 3]
    assert isinstance(doubled[1][0], tse3.SE3) and torch.equal(doubled[1][0].q, 2 * se3.q)
    assert tree_spec(doubled) == tree_spec(tree)
    assert tree_spec((torch.zeros(2), [se3, None, 4], tree[2])) != tree_spec(tree)
    assert tree_spec((torch.zeros(2, dtype=torch.int32),) + tree[1:]) != tree_spec(tree)


def test_fused_step_branches_return_the_same_trees(stereo_runs):
    """The whole fused step with both sides of every cond run and checked
    (the capture's warm-up), from a tracking state and from the initial
    one, on the stereo and the VIO step."""
    _, jb, tf, tb = configs()
    _, tc = cameras(entry._small_cfg())
    imgs0, imgs1 = stereo_frames()
    null = twba.null_correction(tb, device="cpu")
    draws = ttr.make_draws(tf, torch.Generator().manual_seed(0), "cpu")
    fe = ttr.init_state(tf, device="cpu")
    vio = tvim.init_state(tconfig.VioConfig(), device="cpu")
    with control.both_branches():
        for i in range(2):
            x = (torch.as_tensor(imgs0[i]), torch.as_tensor(imgs1[i]))
            (fe, ba, corr), _ = trunner._fused_frame_step(
                tf, tb, tc, null, (fe, twba.empty(tb, device="cpu"), null), x, draws)
        imu = (torch.tensor(0.05), torch.zeros(16, 3), torch.zeros(16, 3),
               torch.linspace(0.0, 0.05, 16), torch.ones(16, dtype=torch.bool))
        trunner._fused_vio_frame_step(tf, tb, tconfig.VioConfig(), tc, tse3.identity(), null,
                                      (fe, ba, vio, corr), x + imu, draws)


# ---------------------------------------------------------- window BA loop
def _lm_loop_early_exit(cam, poses, lm_pw, obs, w_mask, fixed_pose, iters, delta):
    """The loop as an early exit: one host read of `done` a step."""
    obs_uv, obs_ur, ur_valid = obs
    consts = twba._schur_consts(cam, obs, w_mask, fixed_pose)
    cost = twba._total_cost(twba._residuals(cam, poses, lm_pw, obs_uv, obs_ur, ur_valid),
                            w_mask, delta)
    lam = torch.full((), 1e-4)
    for _ in range(iters):
        new_poses, new_lm = twba._schur_step(poses, lm_pw, consts, lam, delta)
        new_cost = twba._total_cost(twba._residuals(cam, new_poses, new_lm, obs_uv, obs_ur,
                                                    ur_valid), w_mask, delta)
        better = new_cost < cost
        poses = tse3.where(better, new_poses, poses)
        lm_pw = torch.where(better, new_lm, lm_pw)
        lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e3))
        done = better & (cost - new_cost < 1e-5 * cost)
        cost = torch.where(better, new_cost, cost)
        if bool(done):
            break
    return poses, lm_pw, cost


@pytest.mark.parametrize("case", ["noisy_init", "outliers", "converges_early"])
def test_sticky_done_equals_early_exit_and_jax(case, monkeypatch):
    """_lm_loop's control.while_loop on (it < iters) & ~done gives the
    early exit's poses, landmarks and cost bit for bit — eagerly, and with
    the loop run as a select on the predicate over a fixed count of body
    runs (every iteration computed, the finished ones discarded on the
    device) — and the reference's optimize at the kernel-vs-XLA bounds of
    tests/test_window_ba.py:201-207."""
    from test_torch_window_ba import JCAM, JCFG, STEP_TOL, TCAM, TCFG, _windows

    kw = {"noisy_init": dict(noise=0.0, pose_noise=0.02, pw_noise=0.1, seed=2),
          "outliers": dict(noise=0.3, pose_noise=0.01, pw_noise=0.05, seed=3),
          "converges_early": dict(noise=0.0, pose_noise=0.0, pw_noise=0.0, seed=5)}[case]
    js, ts = _windows(**kw)
    if case == "outliers":
        uv = ts.obs_uv.clone()
        uv[3, :5] += 60.0
        ts = dataclasses.replace(ts, obs_uv=uv)
        js = js.__class__(**{**js.__dict__, "obs_uv": jnp.asarray(uv.numpy())})
    w_mask = ts.obs_valid & ts.kf_valid[:, None] & ts.lm_valid[None, :]
    fixed = torch.arange(ts.window) == 0
    obs = (ts.obs_uv, ts.obs_ur, ts.obs_ur_valid & w_mask)
    args = (TCAM, ts.poses(), ts.lm_pw, obs, w_mask, fixed, TCFG.iters1, TCFG.huber_delta)
    early = tree_leaves(_lm_loop_early_exit(*args))
    for a, b in zip(tree_leaves(twba._lm_loop(*args)), early):
        assert torch.equal(a, b)
    with monkeypatch.context() as m:
        m.setattr(control, "while_loop", functools.partial(_select_while, bound=TCFG.iters1))
        for a, b in zip(tree_leaves(twba._lm_loop(*args)), early):
            assert torch.equal(a, b)
    jr, tr = jwba.optimize(JCFG, JCAM, js), twba.optimize(TCFG, TCAM, ts)
    live = np.asarray(jr.state.lm_valid)
    assert float(np.abs(tr.state.kf_t.numpy() - np.asarray(jr.state.kf_t)).max()) <= STEP_TOL["t"]
    assert float(np.abs(tr.state.kf_q.numpy() - np.asarray(jr.state.kf_q)).max()) <= STEP_TOL["q"]
    assert float(np.abs(tr.state.lm_pw.numpy()[live]
                        - np.asarray(jr.state.lm_pw)[live]).max()) <= STEP_TOL["lm"]


# ---------------------------------------------------------- no host reads
def _select_cond(pred, true_fn, false_fn, operands=(), name="cond"):
    """cond as the captured graph runs it, without a host read: both
    branches, merged by a select on pred."""
    return tree_map(lambda a, b: torch.where(pred, a, b), true_fn(*operands),
                    false_fn(*operands))


def _select_while(pred_fn, body_fn, carry, name="while", *, bound):
    """while_loop without a host read: `bound` runs of the body (at least
    the loop's iteration count), each kept where the predicate held."""
    for _ in range(bound):
        p = pred_fn(carry)
        carry = tree_map(lambda a, b: torch.where(p, a, b), body_fn(carry), carry)
    return carry


@pytest.mark.parametrize("kind", ["stereo", "vio"])
def test_fused_steps_read_no_host_value(kind, monkeypatch):
    """Every path of the fused step (each cond's both sides), from the
    initial state and from a tracking one, runs without one host read,
    under the guard the capture's warm-up runs under.  On
    the card imu_feed_batch is one kernel launch that picks its mode on the
    device; its plain CPU twin picks it on the host, so the VIO step's IMU
    packet runs outside the check here."""
    _, _, tf, tb = configs()
    _, tc = cameras(entry._small_cfg())
    vcfg = tconfig.VioConfig()
    imgs0, imgs1 = stereo_frames(blank=())
    null = twba.null_correction(tb, device="cpu")
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(control, "cond", _select_cond)
    monkeypatch.setattr(control, "while_loop",
                        functools.partial(_select_while, bound=max(tb.iters1, tb.iters2)))
    feed = tvim.imu_feed_batch

    def feed_unchecked(*a, **kw):
        with torch.utils._python_dispatch._disable_current_modes():
            return feed(*a, **kw)

    monkeypatch.setattr(trunner.vimotion, "imu_feed_batch", feed_unchecked)
    fe, ba = ttr.init_state(tf, device="cpu"), twba.empty(tb, device="cpu")
    vio, corr = tvim.init_state(vcfg, device="cpu"), null
    for i in range(3):
        draws = ttr.make_draws(tf, gen, "cpu")
        x = (torch.as_tensor(imgs0[i]), torch.as_tensor(imgs1[i]))
        imu = (torch.tensor(0.05 * (i + 1)), torch.zeros(16, 3), torch.zeros(16, 3),
               torch.linspace(0.05 * i, 0.05 * (i + 1), 16), torch.ones(16, dtype=torch.bool))
        with control._NoHostRead("the fused step"):
            if kind == "stereo":
                (fe, ba, corr), _ = trunner._fused_frame_step(tf, tb, tc, null,
                                                              (fe, ba, corr), x, draws)
            else:
                (fe, ba, vio, corr), _ = trunner._fused_vio_frame_step(
                    tf, tb, vcfg, tc, tse3.identity(), null, (fe, ba, vio, corr), x + imu,
                    draws)
    assert int(fe.status) == ttr.STATUS_TRACKING
