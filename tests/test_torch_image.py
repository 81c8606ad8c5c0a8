"""Port parity: flvis_tpu_torch.ops.image and the grad_blur kernel module
against flvis_tpu.ops.image (and the Pallas gradpyr kernel in interpret
mode), on the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.ops import image as jimg
from flvis_tpu.ops.pallas.gradpyr import grad_blur_pallas
from flvis_tpu_torch.ops import image as timg
from flvis_tpu_torch.ops.kernels import gradpyr

torch.set_num_threads(1)


def _img(shape, seed=5):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=atol, rtol=0)


class TestGradBlur:
    def test_plain_matches_pallas_interpret_and_sep_filter(self):
        """grad_blur's plain version against the TPU kernel run in interpret
        mode and against scharr_gradients / _sep_filter(_PYR_K).  atol 1e-3
        on [0, 255]: interpret mode shows ~1e-5 FMA-contraction jitter
        against XLA (gradpyr.py:12-18), the plain version follows XLA."""
        x = _img((2, 100, 150))
        t_out = gradpyr.grad_blur_plain(torch.as_tensor(x))
        p_out = grad_blur_pallas(jnp.asarray(x), interpret=True)
        gx, gy = jimg.scharr_gradients(jnp.asarray(x))
        blur = jimg._sep_filter(jnp.asarray(x), jimg._PYR_K, jimg._PYR_K)
        for t, p, r in zip(t_out, p_out, (gx, gy, blur)):
            _close(p, t, 1e-3)
            _close(r, t, 1e-3)

    def test_dispatch_cpu_plain_no_silent_fallback(self):
        """A CPU tensor takes the plain version without launching; the
        kernel wrapper refuses a CPU tensor, and the dispatcher refuses a
        device it has no path for, instead of falling back."""
        x = torch.as_tensor(_img((3, 24, 40)))
        before = gradpyr.grad_blur_kernel.launches
        out = gradpyr.grad_blur(x)
        assert gradpyr.grad_blur_kernel.launches == before
        for a, b in zip(out, gradpyr.grad_blur_plain(x)):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="CUDA"):
            gradpyr.grad_blur_kernel(x)
        with pytest.raises(ValueError, match="unsupported device"):
            gradpyr.grad_blur(torch.empty((3, 24, 40), device="meta"))


@pytest.mark.parametrize("shape", [(3, 96, 160), (96, 160), (2, 61, 87)])
def test_build_grad_pyramid(shape):
    """Same levels, gradients and decimation as the reference's CPU path
    (1e-3: the plain shift-and-add follows XLA's tap order, and XLA:CPU
    contracts some of those multiply-adds into FMAs)."""
    x = _img(shape, seed=6)
    jp = jimg.build_grad_pyramid(jnp.asarray(x), 3, use_kernel=False)
    tp = timg.build_grad_pyramid(torch.as_tensor(x), 3)
    assert len(jp) == len(tp) == 3
    for jl, tl in zip(jp, tp):
        for a, b in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape)
            _close(a, b, 1e-3)


@pytest.mark.parametrize("shape", [(3, 96, 160), (2, 61, 87)])
def test_grad_blur_plain_modes_are_slices_of_full(shape):
    """The "next" mode's image is the full blur at the even pixels and
    "none" drops it; gx and gy are the full mode's, all bit for bit."""
    x = torch.as_tensor(_img(shape, seed=12))
    gx, gy, blur = gradpyr.grad_blur_plain(x)
    ngx, ngy, nxt = gradpyr.grad_blur_plain(x, "next")
    zgx, zgy, none = gradpyr.grad_blur_plain(x, "none")
    h, w = shape[-2:]
    assert tuple(nxt.shape) == (shape[0], (h + 1) // 2, (w + 1) // 2) and nxt.is_contiguous()
    assert torch.equal(nxt, blur[..., ::2, ::2]) and none is None
    for a in (ngx, zgx):
        assert torch.equal(a, gx)
    for a in (ngy, zgy):
        assert torch.equal(a, gy)
    with pytest.raises(ValueError, match="mode"):
        gradpyr.grad_blur(x, "half")


@pytest.mark.parametrize("shape", [(3, 96, 160), (96, 160), (2, 61, 87)])
def test_build_grad_pyramid_is_full_mode_composition(shape):
    """One grad_blur per level in its next / none modes gives the levels of
    the full-mode composition (blur, then a strided slice) bit for bit."""
    x = torch.as_tensor(_img(shape, seed=13))
    got = timg.build_grad_pyramid(x, 3)
    level = x[None] if x.dim() == 2 else x
    for lvl, g in enumerate(got):
        gx, gy, blur = gradpyr.grad_blur_plain(level.contiguous())
        want = (level, gx, gy) if x.dim() == 3 else (level[0], gx[0], gy[0])
        for a, b in zip(g, want):
            assert torch.equal(a, b)
        level = blur[..., ::2, ::2]
    assert len(got) == 3


def test_filters_and_bilinear():
    x = _img((70, 90), seed=7)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    _close(jimg.pyr_down(jx), timg.pyr_down(tx), 1e-3)
    for a, b in zip(jimg.sobel_gradients(jx), timg.sobel_gradients(tx)):
        _close(a, b, 1e-3)
    _close(jimg.box_filter(jx, 2), timg.box_filter(tx, 2), 1e-3)
    _close(jimg.gaussian_blur(jx, 2.0, 7), timg.gaussian_blur(tx, 2.0, 7), 1e-3)
    xy = np.random.default_rng(8).uniform([-5, -5], [95, 75], (200, 2)).astype(np.float32)
    # Bilinear taps of [0, 255] values: 1e-3 covers f32 weight rounding.
    _close(jimg.bilinear_sample(jx, jnp.asarray(xy)),
           timg.bilinear_sample(tx, torch.as_tensor(xy)), 1e-3)


def _centers(n, h, w, seed=9):
    rng = np.random.default_rng(seed)
    c = rng.uniform([-8, -8], [w + 8, h + 8], (n, 2)).astype(np.float32)
    c[:4] = [[-1.5, 3.2], [w + 3.7, h - 2.1], [0.0, 0.0], [w - 1.0, h - 1.0]]
    return c


def test_patch_gathers():
    """Block gathers are exact indexing in both packages (the reference's
    CPU dynamic_slice path clamps starts the same way); the bilinear blend
    of [0, 255] values agrees to 1e-3."""
    h, w = 60, 80
    stack = _img((3, h, w), seed=10)
    c = _centers(50, h, w)
    js, ts = jnp.asarray(stack), torch.as_tensor(stack)
    jc, tc = jnp.asarray(c), torch.as_tensor(c)
    _close(jimg.extract_patches_multi(js, jc, 4), timg.extract_patches_multi(ts, tc, 4), 1e-3)
    _close(jimg.extract_patches(js[0], jc, 3), timg.extract_patches(ts[0], tc, 3), 1e-3)
    _close(jimg.extract_patches_int(js[1], jc, 3), timg.extract_patches_int(ts[1], tc, 3), 0)
    corners = np.floor(c) - 7.0
    corners[5] = [-40.0, -40.0]
    corners[6] = [w + 30.0, h + 30.0]
    jw, jce = jimg.extract_windows(js[2], jnp.asarray(corners), 19)
    tw, tce = timg.extract_windows(ts[2], torch.as_tensor(corners), 19)
    _close(jw, tw, 0)
    np.testing.assert_array_equal(np.asarray(jce), tce.numpy())


def test_equalize_hist_bit_exact():
    """Integer histogram and an exact LUT lookup in both: bit-equal."""
    rng = np.random.default_rng(11)
    x = np.clip(rng.normal(90, 30, (2, 48, 64)), 0, 255).astype(np.float32)
    x[1, :10] = 255.0
    je = np.asarray(jimg.equalize_hist(jnp.asarray(x)))
    te = timg.equalize_hist(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(je, te)
    np.testing.assert_array_equal(np.asarray(jimg.equalize_hist(jnp.asarray(x[0]))),
                                  timg.equalize_hist(torch.as_tensor(x[0])).numpy())
