"""The gather kernel's two modes on the CPU, and the Schur step's inputs
and edge windows: what the card's kernels are held to.

- Patches mode's plain version (ops/kernels/gather.gather_patches_plain)
  equals the composition ops/image used before it — the block gather, then
  the 4-tap blend — bit for bit, on a 2-D image, a (C, H, W) stack and a
  sequence of planes; and it agrees with the JAX package's
  extract_patches / extract_patches_multi within 1e-3 (f32 weight rounding
  of [0, 255] values, as tests/test_torch_image.py states), centres off
  the image included.
- The dispatchers take the plain versions on CPU tensors without launching,
  and the kernel wrappers refuse CPU tensors.
- window_ba._schur_consts, the Schur step's loop-invariant inputs built
  once per LM loop, hold the kernel's argument layout, and the step on them
  equals the plain step bit for bit; and the plain Schur step
  agrees with the reference's Pallas step (interpret mode) on windows that
  hold fewer than 3 keyframes or a keyframe with no observation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.ops import image as jimg
from flvis_tpu_torch.backend import window_ba as twba
from flvis_tpu_torch.ops import image as timg
from flvis_tpu_torch.ops.kernels import gather

from test_torch_window_ba import (JCAM, STEP_TOL, TCAM, _step_errors, _step_inputs, _windows,
                                  jse3, jso3, pallas_schur)

torch.set_num_threads(1)


def _img(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _centers(n, h, w, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform([-9, -9], [w + 9, h + 9], (n, 2)).astype(np.float32)
    c[:6] = [[-1.5, 3.2], [w + 3.7, h - 2.1], [0.0, 0.0], [w - 1.0, h - 1.0],
             [-30.0, h + 30.0], [w * 0.5, -1.0]]
    return c


def _old_composition(img, centers, radius):
    """ops/image.extract_patches(_multi) as it was: _subpixel_corners, the
    (S+1)² block gather, then _blend4."""
    h, w = img.shape[-2:]
    pad = radius + 2
    x = torch.clamp(centers[:, 0], -1.0, w * 1.0)
    y = torch.clamp(centers[:, 1], -1.0, h * 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    xi, yi, fx, fy = x0.long() - radius + pad, y0.long() - radius + pad, x - x0, y - y0
    P = timg._gather_blocks(img, xi, yi, 2 * radius + 2, pad)
    if img.dim() == 2:
        fx, fy = fx[:, None, None], fy[:, None, None]
    else:
        fx, fy = fx[:, None, None, None], fy[:, None, None, None]
    return (P[..., :-1, :-1] * (1 - fx) * (1 - fy) + P[..., :-1, 1:] * fx * (1 - fy)
            + P[..., 1:, :-1] * (1 - fx) * fy + P[..., 1:, 1:] * fx * fy)


@pytest.mark.parametrize("shape,radius,as_planes", [((48, 64), 3, False), ((3, 48, 64), 4, False),
                                                    ((3, 48, 64), 10, True),
                                                    ((2, 23, 31), 13, True)])
def test_patches_plain_equals_old_composition(shape, radius, as_planes):
    x = torch.as_tensor(_img(shape, 1))
    c = torch.as_tensor(_centers(41, shape[-2], shape[-1], 2))
    img = tuple(x) if as_planes else x
    got = gather.gather_patches_plain(img, c, radius)
    ref = _old_composition(x, c, radius)
    assert got.shape == ref.shape and torch.equal(got, ref)
    if x.dim() == 3:
        assert torch.equal(timg.extract_patches_multi(img, c, radius), ref)
    else:
        assert torch.equal(timg.extract_patches(x, c, radius), ref)


@pytest.mark.parametrize("radius", [3, 10])
def test_patches_match_jax(radius):
    h, w = 60, 80
    stack = _img((3, h, w), 10)
    c = _centers(50, h, w, 9)
    js, jc = jnp.asarray(stack), jnp.asarray(c)
    ts, tc = torch.as_tensor(stack), torch.as_tensor(c)
    np.testing.assert_allclose(timg.extract_patches_multi(tuple(ts), tc, radius).numpy(),
                               np.asarray(jimg.extract_patches_multi(js, jc, radius)),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(timg.extract_patches(ts[1], tc, radius).numpy(),
                               np.asarray(jimg.extract_patches(js[1], jc, radius)),
                               atol=1e-3, rtol=0)


def test_windows_plain_takes_planes():
    x = torch.as_tensor(_img((3, 30, 40), 4))
    cx = torch.tensor([-3, 0, 17, 50, 60])
    cy = torch.tensor([0, 44, -2, 9, 40])
    assert torch.equal(gather.gather_windows_plain(tuple(x), cx, cy, 9, 5),
                       gather.gather_windows_plain(x, cx, cy, 9, 5))


def test_gather_dispatch_cpu_plain_no_silent_fallback():
    x = torch.as_tensor(_img((3, 30, 40), 5))
    c = torch.as_tensor(_centers(7, 30, 40, 6))
    cx = torch.tensor([0, 5, 44])
    before = gather.gather_windows_kernel.launches
    assert torch.equal(gather.gather_patches(tuple(x), c, 2), gather.gather_patches_plain(x, c, 2))
    assert torch.equal(gather.gather_windows(x, cx, cx, 7, 3),
                       gather.gather_windows_plain(x, cx, cx, 7, 3))
    assert gather.gather_windows_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_patches_kernel(tuple(x), c, 2)
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_windows_kernel(x, cx, cx, 7, 3)
    meta = torch.empty((30, 40), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather.gather_patches(meta, c, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        gather.gather_windows(meta, cx, cx, 7, 3)


@pytest.mark.parametrize("lam", [1e-4, 1e-1])
def test_schur_consts_match_the_kernel_layout(lam):
    """_schur_consts, built once per _lm_loop, gives the kernel the layout
    that chip_smoke.schur_inputs builds from the window directly, and the
    step on it equals schur_step_plain on those arguments, bit for bit."""
    import chip_smoke
    from flvis_tpu_torch.geometry import se3 as tse3
    from flvis_tpu_torch.ops.kernels import schur

    _, ts = _windows(seed=3)
    args = chip_smoke.schur_inputs(TCAM, ts, lam)
    w_mask = ts.obs_valid & ts.kf_valid[:, None] & ts.lm_valid[None, :]
    fixed = args[6] > 0.5
    consts = twba._schur_consts(TCAM, (ts.obs_uv, ts.obs_ur, ts.obs_ur_valid & w_mask), w_mask,
                                fixed)
    for got, ref in zip(consts, args[3:8]):
        assert torch.equal(got, ref)
    poses, lm = twba._schur_step(ts.poses(), ts.lm_pw, consts, args[8], 2.0)
    dp, dl = schur.schur_step_plain(*args, 2.0)
    ref = tse3.retract_left(ts.poses(), dp)
    assert torch.equal(poses.q, ref.q) and torch.equal(poses.t, ref.t)
    assert torch.equal(lm, ts.lm_pw + dl.T)


@pytest.mark.parametrize("n_kf,drop", [(2, None), (5, 3)])
def test_schur_plain_edge_windows_match_pallas(n_kf, drop):
    """A window with fewer than 3 keyframes (empty slots reach the step:
    optimize always runs it) and one whose keyframe `drop` has no
    observation: the plain step agrees with the Pallas step and leaves the
    unobserved poses where they were."""
    js, ts = _windows(n_kf=n_kf, seed=4)
    poses, w_mask, fixed, urv = _step_inputs(js)
    if drop is not None:
        w_mask = w_mask.at[drop].set(False)
        urv = urv.at[drop].set(False)
    W, L = w_mask.shape
    lam, delta = 1e-3, 2.0
    obs3 = jnp.stack([js.obs_uv[..., 0], js.obs_uv[..., 1], js.obs_ur], 1).reshape(3 * W, L)
    cam_row = jnp.stack([JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy, JCAM.fx * JCAM.baseline])
    dp, dl = pallas_schur(jso3.to_matrix(poses.q).reshape(W, 9), poses.t, js.lm_pw.T, obs3,
                          urv.astype(jnp.float32), w_mask.astype(jnp.float32),
                          fixed.astype(jnp.float32), cam_row, jnp.asarray(lam, jnp.float32),
                          delta=delta, interpret=True)
    kp, kl = jse3.retract_left(poses, dp), js.lm_pw + dl.T
    tw_mask = torch.as_tensor(np.array(w_mask))
    consts = twba._schur_consts(TCAM, (ts.obs_uv, ts.obs_ur, torch.as_tensor(np.array(urv))),
                                tw_mask, torch.as_tensor(np.array(fixed)))
    tp, tl = twba._schur_step(ts.poses(), ts.lm_pw, consts, torch.tensor(lam), delta)
    live = np.asarray(js.lm_valid) & np.asarray(w_mask).any(0)
    for k, v in _step_errors(kp, kl, tp, tl.numpy(), live).items():
        assert v <= STEP_TOL[k], (k, v)
    unobserved = ~tw_mask.any(1)
    assert bool(unobserved.any())
    np.testing.assert_allclose(tp.t[unobserved].numpy(), ts.poses().t[unobserved].numpy(),
                               atol=1e-7, rtol=0)
