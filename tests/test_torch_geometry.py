"""Port parity: flvis_tpu_torch.geometry (so3, se3, camera, triangulation)
against flvis_tpu.geometry on the same seeded numpy inputs.

Tolerance atol 1e-5 (float32 in both; the two frameworks round
transcendental functions and fused expressions differently by a few ulps
of O(1) values) unless stated beside an assert."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.geometry import camera as jcam
from flvis_tpu.geometry import se3 as jse3
from flvis_tpu.geometry import so3 as jso3
from flvis_tpu.geometry import triangulation as jtri
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.geometry import se3 as tse3
from flvis_tpu_torch.geometry import so3 as tso3
from flvis_tpu_torch.geometry import triangulation as ttri

torch.set_num_threads(1)
ATOL = 1e-5
N = 64


def _rng():
    return np.random.default_rng(1234)


def _quats(rng, n=N):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotvecs(rng, n=N, scale=1.0):
    return (rng.normal(size=(n, 3)) * scale).astype(np.float32)


def _vecs(rng, n=N):
    return rng.normal(size=(n, 3)).astype(np.float32)


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.as_tensor(np.array(x)) for x in a]


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=atol, rtol=0)


SO3_CASES = {
    "mul": (lambda r: (_quats(r), _quats(r)), jso3.mul, tso3.mul),
    "conj": (lambda r: (_quats(r),), jso3.conj, tso3.conj),
    "rotate": (lambda r: (_quats(r), _vecs(r)), jso3.rotate, tso3.rotate),
    "to_matrix": (lambda r: (_quats(r),), jso3.to_matrix, tso3.to_matrix),
    "exp": (lambda r: (np.concatenate([_rotvecs(r, 48), _rotvecs(r, 16, 1e-5)]),),
            jso3.exp, tso3.exp),
    "log": (lambda r: (np.asarray(jso3.exp(jnp.asarray(_rotvecs(r, scale=0.8)))),),
            jso3.log, tso3.log),
    "hat": (lambda r: (_vecs(r),), jso3.hat, tso3.hat),
    "from_euler_zyx": (lambda r: (_rotvecs(r, scale=0.5),), jso3.from_euler_zyx,
                       tso3.from_euler_zyx),
    "to_euler_zyx": (lambda r: (_quats(r),), jso3.to_euler_zyx, tso3.to_euler_zyx),
    "normalize": (lambda r: (r.normal(size=(N, 4)).astype(np.float32),), jso3.normalize,
                  tso3.normalize),
}


@pytest.mark.parametrize("name", sorted(SO3_CASES))
def test_so3_matches_jax(name):
    make, jf, tf = SO3_CASES[name]
    args = make(_rng())
    _close(jf(*_j(*args)), tf(*_t(*args)))


def test_so3_from_matrix_and_slerp():
    rng = _rng()
    R = np.asarray(jso3.to_matrix(jnp.asarray(_quats(rng))))
    _close(jso3.from_matrix(jnp.asarray(R)), tso3.from_matrix(torch.as_tensor(np.array(R))))
    q0, q1 = _quats(rng), _quats(rng)
    s = rng.uniform(size=(N, 1)).astype(np.float32)
    _close(jso3.slerp(*_j(q0, q1, s)), tso3.slerp(*_t(q0, q1, s)), atol=1e-4)
    # slerp: arccos near |d| = 1 amplifies f32 rounding; 1e-4 on unit quaternions.


def _poses(rng, n=N):
    q = _quats(rng, n)
    t = _vecs(rng, n)
    return (jse3.SE3(jnp.asarray(q), jnp.asarray(t)),
            tse3.SE3(torch.as_tensor(q), torch.as_tensor(t)))


def _close_se3(a, b, atol=ATOL):
    _close(a.q, b.q, atol)
    _close(a.t, b.t, atol)


def test_se3_compose_inverse_transform():
    rng = _rng()
    ja, ta = _poses(rng)
    jb, tb = _poses(rng)
    _close_se3(jse3.compose(ja, jb), tse3.compose(ta, tb))
    _close_se3(jse3.inverse(ja), tse3.inverse(ta))
    p = _vecs(rng)
    _close(jse3.transform_points(ja, jnp.asarray(p)),
           tse3.transform_points(ta, torch.as_tensor(p)))


def test_se3_exp_log_retract_distance():
    rng = _rng()
    xi = np.concatenate([rng.normal(size=(48, 6)), rng.normal(size=(16, 6)) * 1e-5])
    xi = xi.astype(np.float32)
    _close_se3(jse3.exp(jnp.asarray(xi)), tse3.exp(torch.as_tensor(xi)))
    ja, ta = _poses(rng)
    # log near a half-turn divides by sin(θ/2) → keep to |θ| < 2 rad.
    xi2 = (rng.normal(size=(N, 6)) * 0.5).astype(np.float32)
    jT, tT = jse3.exp(jnp.asarray(xi2)), tse3.exp(torch.as_tensor(xi2))
    _close(jse3.log(jT), tse3.log(tT), atol=2e-5)   # 2e-5: log re-derives θ by atan2
    _close_se3(jse3.retract_left(ja, jnp.asarray(xi2)),
               tse3.retract_left(ta, torch.as_tensor(xi2)))
    jd = jse3.distance(ja, jT)
    td = tse3.distance(ta, tT)
    _close(jd[0], td[0], atol=2e-5)
    _close(jd[1], td[1], atol=2e-5)


def _cams():
    args = (458.0, 457.0, 376.0, 240.0, 0.11)
    return (jcam.make(*args, width=752, height=480),
            tcam.make(*args, width=752, height=480, device="cpu"))


def test_camera_projections():
    rng = _rng()
    jc, tc = _cams()
    pts = np.concatenate([rng.uniform([-3, -2, 0.5], [3, 2, 12], (N, 3)),
                          [[0.1, 0.2, 0.0], [1.0, 1.0, -2.0]]]).astype(np.float32)
    uv = rng.uniform([0, 0], [752, 480], (N, 2)).astype(np.float32)
    d = rng.uniform(0.5, 10, N).astype(np.float32)
    jp, tp = jnp.asarray(pts), torch.as_tensor(pts)
    # Pixel-valued outputs are O(1e3) px → atol 1e-3.  The last two rows
    # (z = 0 and z < 0) only feed the unprojection checks: through the
    # 1e-6 z-guard a one-ulp difference becomes pixels.
    _close(jcam.project(jc, jp)[:N], tcam.project(tc, tp)[:N], atol=1e-3)
    _close(jcam.project_stereo(jc, jp)[:N], tcam.project_stereo(tc, tp)[:N], atol=1e-3)
    _close(jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(d)),
           tcam.backproject(tc, torch.as_tensor(uv), torch.as_tensor(d)))
    _close(jcam.unit_ray(jc, jnp.asarray(uv)), tcam.unit_ray(tc, torch.as_tensor(uv)))
    np.testing.assert_array_equal(np.asarray(jcam.in_bounds(jc, jnp.asarray(uv), 5.0)),
                                  tcam.in_bounds(tc, torch.as_tensor(uv), 5.0).numpy())


def test_triangulation():
    rng = _rng()
    n = N
    P = rng.uniform([-2, -2, 3], [2, 2, 9], (n, 3)).astype(np.float32)
    T0 = (jso3.exp(jnp.zeros(3)), jnp.zeros(3))
    q1 = np.asarray(jso3.exp(jnp.asarray([0.0, 0.05, 0.01])))
    t1 = np.asarray([-0.3, 0.02, 0.05], np.float32)
    j0 = jse3.SE3(*T0)
    j1 = jse3.SE3(jnp.asarray(q1), jnp.asarray(t1))
    t0_ = tse3.SE3(torch.as_tensor(np.array(T0[0])), torch.zeros(3))
    t1_ = tse3.SE3(torch.as_tensor(np.array(q1)), torch.as_tensor(t1))
    x0 = P[:, :2] / P[:, 2:]
    pc1 = np.asarray(jse3.transform_points(j1, jnp.asarray(P)))
    x1 = pc1[:, :2] / pc1[:, 2:] + rng.normal(scale=1e-3, size=(n, 2)).astype(np.float32)
    jq = jse3.SE3(jnp.broadcast_to(j1.q, (n, 4)), jnp.broadcast_to(j1.t, (n, 3)))
    tq = tse3.SE3(t1_.q.expand(n, 4), t1_.t.expand(n, 3))
    jz = jse3.SE3(jnp.broadcast_to(j0.q, (n, 4)), jnp.broadcast_to(j0.t, (n, 3)))
    tz = tse3.SE3(t0_.q.expand(n, 4), t0_.t.expand(n, 3))
    jp, jv = jtri.triangulate_midpoint(jq, jz, jnp.asarray(x1), jnp.asarray(x0))
    tp, tv = ttri.triangulate_midpoint(tq, tz, torch.as_tensor(x1), torch.as_tensor(x0))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    # 1e-4 m: a 0.3 m baseline over 3-9 m depth amplifies f32 ray rounding.
    _close(jp, tp, atol=1e-4)
    jd, jok = jtri.triangulate_from_views(j0, j1, jnp.asarray(x0), jnp.asarray(x1))
    td, tok = ttri.triangulate_from_views(t0_, t1_, torch.as_tensor(x0), torch.as_tensor(x1))
    both = np.asarray(jok) & tok.numpy()
    assert both.mean() > 0.9
    # DLT through two different eigh implementations: 1e-2 relative on the
    # recovered depths (the null vector of a near-rank-3 4×4 in f32).
    np.testing.assert_allclose(td.numpy()[both], np.asarray(jd)[both], rtol=1e-2, atol=1e-2)
