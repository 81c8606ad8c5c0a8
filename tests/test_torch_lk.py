"""Port parity: flvis_tpu_torch.ops.lk (pyramidal and stereo LK) and the
corner detector against flvis_tpu on a rendered stereo pair.

The port samples the LK search window by direct bilinear gathers where the
reference uses hat-function selection matmuls; both give the same weights,
so tracked points agree to float rounding accumulated over the GN
iterations.  Tolerances: status masks must agree except for at most one
borderline point (a gate such as |delta| < eps or the forward-backward
threshold can flip on a 1e-6 px difference); points tracked by both agree
to 2e-3 px."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory
from flvis_tpu.ops import features as jfeat
from flvis_tpu.ops import image as jimg
from flvis_tpu.ops import lk as jlk
from flvis_tpu_torch.ops import features as tfeat
from flvis_tpu_torch.ops import image as timg
from flvis_tpu_torch.ops import lk as tlk

torch.set_num_threads(1)
PX_TOL = 2e-3


@pytest.fixture(scope="module")
def scene_pair():
    scfg = SceneConfig(width=320, height=240, fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                       baseline=0.2)
    scene = PlanarScene(scfg, plane_depth=6.0, seed=3)
    (R0, t0), (R1, t1) = orbit_trajectory(2, step=0.06)
    l0, r0, _ = scene.render(R0, t0)
    l1, _, _ = scene.render(R1, t1)
    stack = np.stack([l0, r0, l1])
    params = jfeat.DetectParams(per_cell=8, min_distance=10.0, margin=16)
    uv, _, valid = jfeat.detect_grid_features(jnp.asarray(l0), jnp.zeros((1, 2)),
                                              jnp.zeros(1, bool), params)
    jp = jimg.build_grad_pyramid(jnp.asarray(stack), 3, use_kernel=False)
    tp = timg.build_grad_pyramid(torch.as_tensor(stack), 3)
    return stack, np.array(uv), np.array(valid), jp, tp, params


def _level(pyr, i):
    return tuple((im[i], gx[i], gy[i]) for im, gx, gy in pyr)


def _agree(jpts, jst, tpts, tst):
    jst, tst = np.asarray(jst), tst.numpy()
    assert int((jst != tst).sum()) <= 1, (jst != tst).sum()
    both = jst & tst
    assert both.sum() > 0.5 * jst.size
    np.testing.assert_allclose(tpts.numpy()[both], np.asarray(jpts)[both], atol=PX_TOL,
                               rtol=0)


def test_detect_grid_features(scene_pair):
    """Same candidates in the same (cell-major, score-descending) order."""
    stack, uv, valid, _, _, params = scene_pair
    tparams = tfeat.DetectParams(**dataclasses.asdict(params))
    existing = uv[:5]
    mask = np.asarray([True, True, False, True, True])
    juv, jsc, jv = jfeat.detect_grid_features(jnp.asarray(stack[0]), jnp.asarray(existing),
                                              jnp.asarray(mask), params)
    tuv, tsc, tv = tfeat.detect_grid_features(torch.as_tensor(stack[0]),
                                              torch.as_tensor(existing),
                                              torch.as_tensor(mask), tparams)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(juv)[np.asarray(jv)], tuv.numpy()[tv.numpy()])
    # Responses are sums of squared Sobel gradients of [0, 255] images:
    # 1e-3 relative covers the two frameworks' f32 rounding.
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("iters", [6, 5])
def test_pyramidal_lk_temporal(scene_pair, iters):
    """Left(t) → left(t+1) with an offset guess; odd and even GN budgets
    (the reference runs GN steps in pairs per while-loop trip)."""
    _, uv, valid, jp, tp, _ = scene_pair
    params = dict(radius=7, num_levels=3, iters=iters)
    guess = uv + np.asarray([3.0, -1.0], np.float32)
    jpts, jst, _ = jlk.pyramidal_lk(_level(jp, 0), _level(jp, 2), jnp.asarray(uv),
                                    jnp.asarray(guess), jnp.asarray(valid),
                                    jlk.LKParams(**params))
    tpts, tst = tlk.pyramidal_lk(_level(tp, 0), _level(tp, 2), torch.as_tensor(uv),
                                 torch.as_tensor(guess), torch.as_tensor(valid),
                                 tlk.LKParams(**params))
    _agree(jpts, jst, tpts, tst)


def test_stereo_lk(scene_pair):
    """Left → right with the disparity prior, vertical and forward-backward
    gates; disparities agree to 2e-3 px where both succeed."""
    _, uv, valid, jp, tp, _ = scene_pair
    disp = np.full(uv.shape[0], 250.0 * 0.2 / 6.0 + 2.0, np.float32)
    params = dict(radius=10, num_levels=3, iters=6)
    jd, jst = jlk.stereo_lk(_level(jp, 0), _level(jp, 1), jnp.asarray(uv),
                            jnp.asarray(disp), jnp.asarray(valid), jlk.LKParams(**params))
    td, tst = tlk.stereo_lk(_level(tp, 0), _level(tp, 1), torch.as_tensor(uv),
                            torch.as_tensor(disp), torch.as_tensor(valid),
                            tlk.LKParams(**params))
    _agree(jd, jst, td, tst)
