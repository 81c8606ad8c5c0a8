"""vio/vimotion of the port against flvis_tpu.vio.vimotion, on the scenes
of tests/test_vimotion.py: the same numpy IMU packets through both
imu_feed_batch's (init packets take the per-sample path, steady packets
the batched path with the attitude kernel's plain twin), then the
feedforward query, the roll/pitch blend and the vision feedback.

Tolerances: ring states and biases 1e-5 (float32 rounding of the same
arithmetic; cumulative sums over a packet and ~100 chained quaternion
products, measured ≤ 2e-6); the attitude chain's plain twin 1e-6 against
both attitude_chain_ref and the Pallas kernel in interpret mode (the
kernel's small-angle series differs from the exact exp by ~1e-7,
imu_chain.py:17-21)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.config import VioConfig as JVioConfig
from flvis_tpu.geometry import se3 as jse3, so3 as jso3
from flvis_tpu.ops.pallas.imu_chain import attitude_chain_pallas, attitude_chain_ref
from flvis_tpu.vio import vimotion as jv
from flvis_tpu_torch.config import VioConfig
from flvis_tpu_torch.geometry import se3 as tse3, so3 as tso3
from flvis_tpu_torch.interop import to_numpy
from flvis_tpu_torch.ops.kernels import imu_chain
from flvis_tpu_torch.vio import vimotion as tv

torch.set_num_threads(1)
TOL = 1e-5
KW = dict(imu_capacity=256, init_samples=20)
JCFG, TCFG = JVioConfig(**KW), VioConfig(**KW)


def static_samples(n, dt=0.005, t0=0.0, rpy=(0.0, 0.0, 0.0), rng=None, noise=0.0):
    """tests/test_vimotion.py:static_samples, as numpy."""
    q = jso3.from_euler_zyx(jnp.asarray(rpy))
    g_imu = np.asarray(jso3.rotate(jso3.conj(q), jnp.asarray([0.0, 0.0, 9.81])))
    acc = np.tile(g_imu, (n, 1))
    gyro = np.zeros((n, 3))
    if rng is not None and noise > 0:
        acc = acc + rng.normal(scale=noise, size=acc.shape)
        gyro = gyro + rng.normal(scale=noise * 0.1, size=gyro.shape)
    t = t0 + dt * np.arange(1, n + 1)
    return acc.astype(np.float32), gyro.astype(np.float32), t.astype(np.float32)


class Pair:
    """The JAX and the port VIO state, fed the same packets."""

    def __init__(self, jcfg=JCFG, tcfg=TCFG):
        self.jcfg, self.tcfg = jcfg, tcfg
        self.j = jv.init_state(jcfg)
        self.t = tv.init_state(tcfg, device="cpu")

    def feed(self, acc, gyro, t, valid=None):
        jvalid = None if valid is None else jnp.asarray(valid)
        tvalid = None if valid is None else torch.as_tensor(valid)
        self.j = jv.imu_feed_batch(self.jcfg, self.j, jnp.asarray(acc), jnp.asarray(gyro),
                                   jnp.asarray(t), jvalid)
        self.t = tv.imu_feed_batch(self.tcfg, self.t, torch.as_tensor(acc),
                                   torch.as_tensor(gyro), torch.as_tensor(t), tvalid)

    def correct(self, t_img, q_w_i, p_w_i):
        """Vision says T_w_i = (q, p) at t_img (T_i_c = identity)."""
        jT = jse3.inverse(jse3.SE3(jnp.asarray(q_w_i), jnp.asarray(p_w_i)))
        tT = tse3.inverse(tse3.SE3(torch.as_tensor(q_w_i), torch.as_tensor(p_w_i)))
        self.j = jv.correction_from_vision(self.jcfg, self.j, jnp.asarray(t_img, jnp.float32),
                                           jT, jse3.identity())
        self.t = tv.correction_from_vision(self.tcfg, self.t, t_img, tT, tse3.identity())

    def check(self):
        jd, td = to_numpy(self.j), to_numpy(self.t)
        assert set(jd) == set(td)
        for k in jd:
            np.testing.assert_allclose(np.asarray(td[k], np.float64),
                                       np.asarray(jd[k], np.float64), atol=TOL, rtol=0,
                                       err_msg=k)


def _init(pair, n=30, **kw):
    acc, gyro, t = static_samples(n, **kw)
    pair.feed(acc, gyro, t)
    pair.check()
    return float(t[-1])


def test_init_split_packets():
    """19 samples leave the filter uninitialised, 5 more initialise it."""
    p = Pair()
    acc, gyro, t = static_samples(19)
    p.feed(acc, gyro, t)
    assert not bool(p.t.initialized)
    p.check()
    acc, gyro, t = static_samples(5, t0=float(t[-1]))
    p.feed(acc, gyro, t)
    assert bool(p.t.initialized)
    p.check()


@pytest.mark.parametrize("rpy,gyro_bias", [((0.15, -0.1, 0.0), (0.0, 0.0, 0.0)),
                                           ((0.0, 0.0, 0.0), (0.01, -0.02, 0.005))])
def test_init_attitude_and_gyro_bias(rpy, gyro_bias):
    p = Pair()
    acc, gyro, t = static_samples(40, rpy=rpy)
    p.feed(acc, gyro + np.float32(gyro_bias), t)
    p.check()
    np.testing.assert_allclose(p.t.bias_gyro.numpy(), gyro_bias, atol=1e-4)


@pytest.mark.parametrize("scene", ["static", "yaw", "accel"])
def test_propagation_scenes(scene):
    p = Pair()
    t0 = _init(p)
    n, dt = (100, 0.005) if scene != "yaw" else (200, 0.005)
    t = (t0 + dt * np.arange(1, n + 1)).astype(np.float32)
    if scene == "static":
        acc, gyro, _ = static_samples(n, t0=t0)
    elif scene == "yaw":
        gyro = np.tile([0.0, 0.0, 0.5], (n, 1)).astype(np.float32)
        acc = np.tile([0.0, 0.0, 9.81], (n, 1)).astype(np.float32)
    else:
        acc = np.tile([1.0, 0.0, 9.81], (n, 1)).astype(np.float32)
        gyro = np.zeros((n, 3), np.float32)
    # Frame-sized packets of 16, as the runner feeds them.
    for k in range(0, n, 16):
        p.feed(acc[k:k + 16], gyro[k:k + 16], t[k:k + 16])
        p.check()


def test_masked_dynamic_packet():
    """A noisy dynamic packet padded to 16 with 5 invalid rows."""
    rng = np.random.default_rng(4)
    p = Pair()
    acc, gyro, t = static_samples(40, rng=rng, noise=0.02)
    p.feed(acc, gyro, t)
    acc = rng.normal([0.4, -0.2, 9.6], 0.3, (16, 3)).astype(np.float32)
    gyro = rng.normal(0.03, 0.15, (16, 3)).astype(np.float32)
    t = (0.3 + 0.005 * np.arange(1, 17)).astype(np.float32)
    p.feed(acc, gyro, t, valid=np.arange(16) < 11)
    p.check()


def test_feedforward_and_find_state():
    p = Pair()
    t0 = _init(p, n=60)
    for tq in (t0 - 0.001, t0 + 100.0, t0 - 0.1):
        jf = jv.get_frame_state(p.j, jnp.asarray(tq, jnp.float32), jse3.identity())
        tf = tv.get_frame_state(p.t, tq, tse3.identity())
        assert int(tf.idx) == int(jf.idx) and bool(tf.ok) == bool(jf.ok)
        np.testing.assert_allclose(tf.T_c_w.t.numpy(), np.asarray(jf.T_c_w.t), atol=TOL)
        np.testing.assert_allclose(tf.T_c_w.q.numpy(), np.asarray(jf.T_c_w.q), atol=TOL)
    # Before every buffered sample: not ok.
    q = Pair()
    _init(q, n=40, t0=100.0)
    assert not bool(tv.get_frame_state(q.t, 50.0, tse3.identity()).ok)


def test_corrections_rebase_and_update_biases():
    """First correction snaps the chain; the second (0.05 s later) moves the
    biases and the velocities (tests/test_vimotion.py:117-166)."""
    p = Pair()
    t0 = _init(p, n=60)
    acc, gyro, t = static_samples(30, t0=t0)
    p.feed(acc, gyro, t)
    t1 = t0 + 0.05
    p.correct(t1, [1.0, 0, 0, 0], [1.0, 0.0, 0.0])
    p.check()
    q2 = np.asarray(jso3.from_euler_zyx(jnp.asarray([0.0, 0.0, 0.002])), np.float32)
    p.correct(t1 + 0.05, q2, [1.0005, 0.0, 0.0])
    p.check()
    assert abs(float(p.t.bias_acc[0])) > 1e-3


def test_correction_skips_innovation_when_last_state_evicted():
    kw = dict(imu_capacity=64, init_samples=20)
    p = Pair(JVioConfig(**kw), VioConfig(**kw))
    t0 = _init(p, n=30)
    p.correct(t0, [1.0, 0, 0, 0], [0.0, 0.0, 0.0])
    acc, gyro, t = static_samples(80, t0=t0 + 10.0)
    for k in range(0, 80, 16):
        p.feed(acc[k:k + 16], gyro[k:k + 16], t[k:k + 16])
    p.correct(float(t[-1]), [1.0, 0, 0, 0], [0.5, 0.0, 0.0])
    p.check()
    np.testing.assert_allclose(p.t.bias_acc.numpy(), 0.0, atol=1e-6)


def test_rp_compensation():
    qv = np.asarray(jso3.from_euler_zyx(jnp.asarray([0.1, 0.0, 0.7])))
    qi = np.asarray(jso3.from_euler_zyx(jnp.asarray([0.0, 0.2, 0.3])))
    got = tv.vision_rp_compensation(torch.as_tensor(qv), torch.as_tensor(qi), 0.5)
    ref = jv.vision_rp_compensation(jnp.asarray(qv), jnp.asarray(qi), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    T = (np.asarray(jso3.from_euler_zyx(jnp.asarray([0.05, -0.1, 0.4]))),
         np.asarray([0.3, -0.2, 1.0], np.float32))
    Tic = (np.asarray(jso3.from_euler_zyx(jnp.asarray([0.01, 0.02, -0.03]))),
           np.asarray([0.05, 0.0, -0.02], np.float32))
    got = tv.rp_compensate_pose(TCFG, tse3.SE3(*map(torch.as_tensor, T)), torch.as_tensor(qi),
                                tse3.SE3(*map(torch.as_tensor, Tic)))
    ref = jv.rp_compensate_pose(JCFG, jse3.SE3(*map(jnp.asarray, T)), jnp.asarray(qi),
                                jse3.SE3(*map(jnp.asarray, Tic)))
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), atol=1e-6)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-6)


def test_madgwick_converges_like_reference():
    q_true = jso3.from_euler_zyx(jnp.asarray([0.2, 0.0, 0.0]))
    acc = np.asarray(jso3.rotate(jso3.conj(q_true), jnp.asarray([0.0, 0.0, 9.81])))
    qj, qt = jso3.identity(), tso3.identity()
    for _ in range(600):
        qj = jv._madgwick_step(qj, jnp.zeros(3), jnp.asarray(acc), 0.08, 0.005)
        qt = tv._madgwick_step(qt, torch.zeros(3), torch.as_tensor(acc), 0.08, 0.005)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-5)
    assert abs(float(tso3.to_euler_zyx(qt)[0]) - 0.2) < 0.03


@pytest.mark.parametrize("seed", [5, 6])
def test_attitude_chain_plain_matches_ref_and_interpret_kernel(seed):
    rng = np.random.default_rng(seed)
    P = 16
    q0 = rng.normal(0, 1, 4)
    q0 = (q0 / np.linalg.norm(q0)).astype(np.float32)
    G = np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.01, (P, 3)).astype(np.float32))))
    a = rng.normal(0, 1, (P, 3))
    a = (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
    c = rng.uniform(0, 0.003, P).astype(np.float32)
    got = imu_chain.attitude_chain(*(torch.as_tensor(x) for x in (q0, G, a, c))).numpy()
    jargs = [jnp.asarray(x) for x in (q0, G, a, c)]
    np.testing.assert_allclose(got, np.asarray(attitude_chain_ref(*jargs)), atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(attitude_chain_pallas(*jargs, interpret=True)),
                               atol=1e-6)
