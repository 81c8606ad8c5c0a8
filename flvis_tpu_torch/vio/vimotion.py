"""VIMOTION: IMU attitude/position propagation with vision feedback
(port of flvis_tpu/vio/vimotion.py).

A fixed ring of IMU states; a Madgwick complementary filter for attitude
during initialisation and propagation, Euler position/velocity integration
under gravity, a feedforward pose query at image timestamps with roll/pitch
blending into the vision pose, and feedback bias estimation from pairs of
vision poses.  World = ENU with gravity −z; q_w_i rotates IMU-frame vectors
into the world.

How the JAX control flow carries over:
  - The lax.cond on `state.initialized` (vimotion.py:148-153) is a host
    branch: one device→host read per packet.
  - `_feed_scan`'s lax.scan is a Python loop over the samples (it runs only
    while the filter initialises); both branches of each sample are
    computed and selected on the device, as in the reference.
  - `lax.cummax` is `torch.cummax`; the masked ring scatter (`mode="drop"`)
    writes into one spare row that is then cut off.
  - The steady-state attitude recurrence goes through
    ops/kernels/imu_chain.attitude_chain (the CUDA kernel on the card).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import VioConfig
from ..geometry import se3 as se3m, so3
from ..geometry.se3 import SE3
from ..ops.kernels.imu_chain import attitude_chain


@dataclasses.dataclass(frozen=True)
class VioState:
    # Ring buffer, chronological by slot age: `head` points at the slot the
    # NEXT sample overwrites; valid entries are the `count` most recent.
    t: torch.Tensor           # (C,) seconds, −1 empty
    pos: torch.Tensor         # (C, 3)
    vel: torch.Tensor         # (C, 3)
    q: torch.Tensor           # (C, 4) q_w_i
    acc: torch.Tensor         # (C, 3) raw
    gyro: torch.Tensor        # (C, 3) raw
    head: torch.Tensor        # int32
    count: torch.Tensor       # int32
    bias_acc: torch.Tensor    # (3,)
    bias_gyro: torch.Tensor   # (3,)
    initialized: torch.Tensor  # bool
    init_acc_sum: torch.Tensor   # (3,)
    init_gyro_sum: torch.Tensor  # (3,)
    init_count: torch.Tensor     # int32
    # Previous accepted vision pose (T_w_i) and its image time; last_vis_t < 0
    # means no vision lock yet.
    last_vis_t: torch.Tensor
    last_vis_q: torch.Tensor
    last_vis_p: torch.Tensor


def init_state(cfg: VioConfig, *, device, dtype=torch.float32) -> VioState:
    c = cfg.imu_capacity

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return VioState(
        t=torch.full((c,), -1.0, dtype=dtype, device=device), pos=z(c, 3), vel=z(c, 3),
        q=so3.identity((c,), dtype, device), acc=z(c, 3), gyro=z(c, 3),
        head=i32(0), count=i32(0), bias_acc=z(3), bias_gyro=z(3),
        initialized=torch.tensor(False, device=device),
        init_acc_sum=z(3), init_gyro_sum=z(3), init_count=i32(0),
        last_vis_t=torch.tensor(-1.0, dtype=dtype, device=device),
        last_vis_q=so3.identity((), dtype, device), last_vis_p=z(3))


def _latest(state: VioState):
    return ((state.head - 1) % state.t.shape[0]).long()


def _attitude_from_gravity(acc):
    """Initial roll/pitch from the measured gravity direction (yaw = 0)."""
    a = acc / torch.clamp(torch.linalg.vector_norm(acc), min=1e-6)
    roll = torch.atan2(a[1], a[2])
    pitch = torch.atan2(-a[0], torch.sqrt(a[1] ** 2 + a[2] ** 2))
    return so3.from_euler_zyx(torch.stack([roll, pitch, torch.zeros_like(roll)]))


def _madgwick_step(q, gyro, acc, beta, dt):
    """One Madgwick update of q_w_i: gyro integration plus a proportional
    pull of the predicted gravity direction toward the accelerometer."""
    q_prop = so3.mul(q, so3.exp(gyro * dt))
    a_norm = torch.linalg.vector_norm(acc)
    a = acc / torch.clamp(a_norm, min=1e-6)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=q.dtype, device=q.device)
    g_pred = so3.rotate(so3.conj(q_prop), z)
    err = torch.linalg.cross(a, g_pred)
    trust = torch.exp(-torch.abs(a_norm - 9.81) / 9.81 * 5.0)
    corr = so3.exp(err * (10.0 * beta) * trust * dt)
    return so3.normalize(so3.mul(q_prop, corr))


def imu_feed_batch(cfg: VioConfig, state: VioState, acc_batch, gyro_batch, t_batch,
                   valid=None) -> VioState:
    """Integrate a packet of IMU samples (B, 3), (B, 3), (B,); `valid` masks
    padding rows.  Initialised filters take the batched steady path with the
    attitude kernel; during initialisation the per-sample path runs."""
    if valid is None:
        valid = torch.ones(t_batch.shape[0], dtype=torch.bool, device=t_batch.device)
    if bool(state.initialized):
        return _feed_prop_batch(cfg, state, acc_batch, gyro_batch, t_batch, valid)
    return _feed_scan(cfg, state, acc_batch, gyro_batch, t_batch, valid)


def _ring_append(state: VioState, valid, rows) -> VioState:
    """Append per-sample rows (t, q, pos, vel, acc, gyro) to the ring; rows
    with valid=False land in a spare row past the end and are dropped."""
    C = state.t.shape[0]
    vi = valid.to(torch.int32)
    n_ok = torch.sum(vi)
    slot = (state.head + torch.cumsum(vi, 0) - vi) % C
    idx = torch.where(valid, slot, C).long()

    def put(a, r):
        buf = torch.cat([a, a[:1]])
        return buf.index_copy(0, idx, r.to(a.dtype))[:C]

    r_t, r_q, r_p, r_v, r_a, r_g = rows
    return dataclasses.replace(
        state, t=put(state.t, r_t), q=put(state.q, r_q), pos=put(state.pos, r_p),
        vel=put(state.vel, r_v), acc=put(state.acc, r_a), gyro=put(state.gyro, r_g),
        head=((state.head + n_ok) % C).to(torch.int32),
        count=torch.clamp(state.count + n_ok, max=C).to(torch.int32))


def _feed_prop_batch(cfg: VioConfig, state: VioState, acc_b, gyro_b, t_b,
                     valid) -> VioState:
    """Steady-state propagation of a whole packet: batched precompute, the
    sequential attitude kernel, and cumulative-sum integrals."""
    dtype, dev = state.t.dtype, state.t.device
    g_w = torch.tensor([0.0, 0.0, -cfg.gravity], dtype=dtype, device=dev)
    j = _latest(state)
    t_l, q_l = state.t[j], state.q[j]
    p_l, v_l = state.pos[j], state.vel[j]
    am = acc_b - state.bias_acc[None, :]
    gm = gyro_b - state.bias_gyro[None, :]
    # dt_k = clip(t_k − t_prev, 1e-4, 0.05) with t_prev the previous valid
    # sample's time (running max over monotonic timestamps).
    t_eff = torch.where(valid, t_b, -torch.inf)
    prev_t = torch.cummax(torch.cat([t_l[None], t_eff]), 0).values[:-1]
    dt = torch.clamp(t_b - prev_t, 1e-4, 0.05)
    G = so3.exp(gm * dt[:, None])
    G = torch.where(valid[:, None], G, so3.identity((), dtype, dev)[None, :])
    a_norm = torch.linalg.vector_norm(am, dim=-1)
    a_unit = am / torch.clamp(a_norm, min=1e-6)[:, None]
    trust = torch.exp(-torch.abs(a_norm - 9.81) / 9.81 * 5.0)
    vf = valid.to(dtype)
    c = (10.0 * cfg.madgwick_beta) * trust * dt * vf
    qs = attitude_chain(q_l.contiguous(), G.contiguous(), a_unit.contiguous(),
                        c.contiguous())
    acc_w = so3.rotate(qs, am) + g_w[None, :]
    dt_v = dt * vf
    vel = v_l[None, :] + torch.cumsum(acc_w * dt_v[:, None], 0)
    vel_prev = torch.cat([v_l[None, :], vel[:-1]], 0)
    pos = p_l[None, :] + torch.cumsum(
        vel_prev * dt_v[:, None] + 0.5 * acc_w * (dt_v ** 2)[:, None], 0)
    return _ring_append(state, valid, (t_b, qs, pos, vel, acc_b, gyro_b))


def _feed_scan(cfg: VioConfig, state: VioState, acc_batch, gyro_batch, t_batch,
               valid) -> VioState:
    """Per-sample path (initialisation and mixed init/propagation packets)."""
    dtype, dev = state.t.dtype, state.t.device
    g_w = torch.tensor([0.0, 0.0, -cfg.gravity], dtype=dtype, device=dev)
    j = _latest(state)
    carry = (state.t[j], state.q[j], state.pos[j], state.vel[j], state.bias_acc,
             state.bias_gyro, state.initialized, state.init_acc_sum, state.init_gyro_sum,
             state.init_count)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    rows = []
    for k in range(t_batch.shape[0]):
        acc, gyro, t, ok = acc_batch[k], gyro_batch[k], t_batch[k], valid[k]
        t_l, q_l, p_l, v_l, ba, bg, inited, a_sum, g_sum, n_init = carry
        # Initialisation: gravity mean seeds the attitude; the gyro mean is
        # latched as the gyro bias once enough samples arrived.
        n = n_init + 1
        a_s = a_sum + acc
        g_s = g_sum + gyro
        done = n >= cfg.init_samples
        q0 = _attitude_from_gravity(a_s / n.to(dtype))
        bg2 = torch.where(done, g_s / n.to(dtype), bg)
        init_new = (t, q0, zero3, zero3, ba, bg2, inited | done, a_s, g_s, n)
        # Propagation (Madgwick attitude + Euler integration under gravity).
        dt = torch.clamp(t - t_l, 1e-4, 0.05)
        q = _madgwick_step(q_l, gyro - bg, acc - ba, cfg.madgwick_beta, dt)
        acc_w = so3.rotate(q, acc - ba) + g_w
        prop_new = (t, q, p_l + v_l * dt + 0.5 * acc_w * dt * dt, v_l + acc_w * dt,
                    ba, bg, inited, a_sum, g_sum, n_init)
        new = tuple(torch.where(inited, p, i) for p, i in zip(prop_new, init_new))
        carry = tuple(torch.where(ok, b, a) for a, b in zip(carry, new))
        rows.append((new[0], new[1], new[2], new[3]))
    _, _, _, _, ba, bg, inited, a_sum, g_sum, n_init = carry
    r_t, r_q, r_p, r_v = (torch.stack(x) for x in zip(*rows))
    state = _ring_append(state, valid, (r_t, r_q, r_p, r_v, acc_batch, gyro_batch))
    return dataclasses.replace(state, bias_acc=ba, bias_gyro=bg, initialized=inited,
                               init_acc_sum=a_sum, init_gyro_sum=g_sum,
                               init_count=n_init.to(torch.int32))


def find_state_idx(state: VioState, t_query):
    """Ring index of the newest state with t ≤ t_query (first index among
    ties, as jnp.argmin)."""
    dt = t_query - state.t
    dt = torch.where((state.t >= 0) & (dt >= 0), dt, torch.inf)
    return torch.argmin(dt)


class FeedforwardPose(NamedTuple):
    T_c_w: SE3
    q_w_i: torch.Tensor
    pos: torch.Tensor
    vel: torch.Tensor
    idx: torch.Tensor
    ok: torch.Tensor


def _scalar(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def get_frame_state(state: VioState, t_img, T_i_c: SE3) -> FeedforwardPose:
    """Feedforward: the IMU pose prediction at an image timestamp, as the
    camera-from-world pose (T_i_c is the camera-in-IMU extrinsic)."""
    t_img = _scalar(t_img, state.t)
    i = find_state_idx(state, t_img)
    q_w_i, pos = state.q[i], state.pos[i]
    T_c_w = se3m.inverse(se3m.compose(SE3(q_w_i, pos), T_i_c))
    # No buffered state at or before t_img: argmin over all-inf picked slot 0.
    has_past = torch.any((state.t >= 0) & (state.t <= t_img))
    ok = state.initialized & (state.count > 0) & has_past
    return FeedforwardPose(T_c_w, q_w_i, pos, state.vel[i], i, ok)


def vision_rp_compensation(q_vision_w_i, q_imu_w_i, blend: float):
    """Blend IMU roll/pitch into the vision attitude, keep vision yaw."""
    rpy_v = so3.to_euler_zyx(q_vision_w_i)
    rpy_i = so3.to_euler_zyx(q_imu_w_i)
    blended = torch.stack([(1.0 - blend) * rpy_v[..., 0] + blend * rpy_i[..., 0],
                           (1.0 - blend) * rpy_v[..., 1] + blend * rpy_i[..., 1],
                           rpy_v[..., 2]], dim=-1)
    return so3.from_euler_zyx(blended)


def rp_compensate_pose(cfg: VioConfig, T_c_w_vision: SE3, q_w_i_imu, T_i_c: SE3) -> SE3:
    """Blend the IMU roll/pitch into a vision camera pose (weight
    cfg.rp_blend), keeping the vision position."""
    T_w_c = se3m.inverse(T_c_w_vision)
    T_w_i_vis = se3m.compose(T_w_c, se3m.inverse(T_i_c))
    q_blend = vision_rp_compensation(T_w_i_vis.q, q_w_i_imu, cfg.rp_blend)
    T_w_i = SE3(so3.normalize(q_blend), T_w_i_vis.t)
    return se3m.inverse(se3m.compose(T_w_i, T_i_c))


def correction_from_vision(cfg: VioConfig, state: VioState, t_img, T_c_w_vision: SE3,
                           T_i_c: SE3) -> VioState:
    """Feedback: rebase the IMU state history onto a vision pose and update
    the bias estimates by IIR toward the vision-vs-IMU innovation
    (reference semantics as documented in flvis_tpu/vio/vimotion.py:366-392;
    the gyro IIR decays by (1 − acc_bias_gain) but gains by gyro_bias_gain,
    as the reference does)."""
    t_img = _scalar(t_img, state.t)
    eps = 1e-6
    i_b = find_state_idx(state, t_img)
    T_w_iB = se3m.compose(se3m.inverse(T_c_w_vision), se3m.inverse(T_i_c))

    t_last = state.last_vis_t
    i_a = find_state_idx(state, t_last)
    dt = t_img - t_last
    has_last_state = torch.any((state.t >= 0) & (state.t <= t_last))
    have_last = (t_last >= 0) & has_last_state & (i_a != i_b) & (dt > eps)

    q_BA = so3.mul(so3.conj(T_w_iB.q), state.last_vis_q)
    q_ba = so3.mul(so3.conj(state.q[i_b]), state.q[i_a])
    q_Bb = so3.normalize(so3.mul(q_BA, so3.conj(q_ba)))
    dt_safe = torch.where(have_last, dt, torch.ones_like(dt))
    gyro_est = q_Bb[1:4] / dt_safe

    in_win = (state.t >= t_last) & (state.t <= t_img) & (state.t >= 0)
    n_win = torch.clamp(torch.sum(in_win), min=1)
    vel_imu = torch.sum(torch.where(in_win[:, None], state.vel, 0.0), dim=0) / n_win
    vel_vis = (T_w_iB.t - state.last_vis_p) / dt_safe
    diff_vel = torch.where(have_last, vel_vis - vel_imu, 0.0)
    i_m = find_state_idx(state, 0.5 * (t_last + t_img))
    acc_est = -so3.rotate(so3.conj(state.q[i_m]), diff_vel) / dt_safe

    def sat(v, cap):
        n = torch.linalg.vector_norm(v)
        return v * torch.clamp(cap / torch.clamp(n, min=eps), max=1.0)

    acc_est = torch.where(torch.all(torch.isfinite(acc_est)),
                          sat(acc_est, cfg.acc_bias_sat), 0.0)
    gyro_est = torch.where(torch.all(torch.isfinite(gyro_est)),
                           sat(gyro_est, cfg.gyro_bias_sat), 0.0)
    upd = have_last & (dt < 0.1)
    p3, p4 = cfg.acc_bias_gain, cfg.gyro_bias_gain
    bias_acc = torch.where(upd, (1.0 - p3) * state.bias_acc + p3 * acc_est,
                           state.bias_acc)
    bias_gyro = torch.where(upd, (1.0 - p3) * state.bias_gyro + p4 * gyro_est,
                            state.bias_gyro)

    newer = (state.t >= state.t[i_b]) & (state.t >= 0)
    dq = so3.mul(T_w_iB.q, so3.conj(state.q[i_b]))
    q_new = so3.normalize(so3.mul(dq[None, :], state.q))
    pos_new = so3.rotate(dq[None, :], state.pos - state.pos[i_b][None, :]) + T_w_iB.t[None, :]
    vel_new = state.vel + diff_vel[None, :]
    nw = newer[:, None]
    return dataclasses.replace(
        state, q=torch.where(nw, q_new, state.q), pos=torch.where(nw, pos_new, state.pos),
        vel=torch.where(nw, vel_new, state.vel), bias_acc=bias_acc, bias_gyro=bias_gyro,
        last_vis_t=t_img.clone(), last_vis_q=T_w_iB.q, last_vis_p=T_w_iB.t)
