"""ops/orb and ops/stereo of the port, and the plain twins of the fastblur,
hamming and sweep kernels, against the JAX package on the same numpy
images (rendered by PlanarScene, or uniform noise).

The JAX side runs the Pallas kernels in interpret mode on small images
(96×160 full-res, 48×80 half-res): interpret mode at 752×480 would not fit
tier-1.  Tolerances:
  - fastblur twin vs the interpreted kernel: score and blur within 1e-3
    (sum-order rounding on [0, 255] inputs; measured ≤ 3e-5);
  - vs the XLA `fast_score` path: the same corners survive inside the
    margin (the two border semantics differ only within 3 px of the edge),
    their scores within 1e-3 (sum order; measured ≤ 1.3e-4 on scores
    ~1e3);
  - detect_and_compute: the valid keypoint SETS equal (torch.topk and
    approx_max_k may order ties differently), angles within 1e-4 rad and
    descriptors equal up to 2 near-tie bits per keypoint (the bilinear
    BRIEF samples round differently in the two einsums);
  - hamming twin vs both JAX forms, and mutual_ratio_match: exact;
  - sweep twin vs the interpreted kernel, and disparity_sweep vs JAX's
    `disparity_sweep(use_kernel=True)`: disparity within 1e-3 where both are
    ok, the ok masks equal on all but ≤ 1 % of pixels (argmin near-ties: the
    half-res means and box sums round differently in the two frameworks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.io.synthetic import PlanarScene, SceneConfig
from flvis_tpu.ops import orb as jorb, stereo as jstereo
from flvis_tpu.ops.pallas.fastblur import fast_score_nms_blur_pallas
from flvis_tpu.ops.pallas.hamming import hamming_matrix_pallas
from flvis_tpu.ops.pallas.sweep import sweep_maps_pallas
from flvis_tpu_torch.ops import orb as torb, stereo as tstereo
from flvis_tpu_torch.ops.kernels import fastblur, hamming, sweep

torch.set_num_threads(1)
SCFG = SceneConfig(width=160, height=96, fx=400.0, fy=400.0, cx=80.0, cy=48.0,
                   baseline=0.12)


@pytest.fixture(scope="module")
def pair():
    scene = PlanarScene(SCFG, plane_depth=2.0, seed=3)
    l, r, _ = scene.render(np.eye(3), np.zeros(3))
    return np.asarray(l, np.float32), np.asarray(r, np.float32)


def _u32(desc_t):
    return desc_t.numpy().view(np.uint32)


@pytest.mark.parametrize("margin", [6, 20])
def test_fastblur_plain_matches_interpret_kernel(pair, margin):
    img = pair[0]
    s_t, b_t = fastblur.fast_score_nms_blur(torch.as_tensor(img), 20.0, margin)
    s_j, b_j = fast_score_nms_blur_pallas(jnp.asarray(img), 20.0, margin=margin,
                                          interpret=True)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-3, rtol=0)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-3, rtol=0)
    assert (s_t.numpy() > 0).sum() > 20


def test_fastblur_matches_xla_fast_score_inside_margin():
    """Uniform noise (many corners) through the XLA formulation:
    fast_score → 3×3 max → keep ties → margin mask."""
    img = np.random.default_rng(3).uniform(0, 255, (60, 90)).astype(np.float32)
    margin = 6
    raw = jorb.fast_score(jnp.asarray(img), 20.0)
    pooled = jax.lax.reduce_window(raw, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
    yy, xx = np.arange(60)[:, None], np.arange(90)[None, :]
    ok = (yy >= margin) & (yy < 60 - margin) & (xx >= margin) & (xx < 90 - margin)
    ref = np.where((np.asarray(raw) >= np.asarray(pooled)) & ok, np.asarray(raw), 0.0)
    got, _ = fastblur.fast_score_nms_blur(torch.as_tensor(img), 20.0, margin)
    np.testing.assert_array_equal(got.numpy() > 0, ref > 0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)
    # The port's own roll-wrap fast_score equals the reference's everywhere.
    np.testing.assert_allclose(torb.fast_score(torch.as_tensor(img)).numpy(),
                               np.asarray(raw), atol=1e-3, rtol=0)


def test_fastblur_kernel_bit_tricks_over_all_masks():
    """csrc/fastblur.cu's ring test, modelled bit for bit in numpy: with
    m = thr − |d|, sign(m) & ~sign(d) and sign(m) & sign(d) are the plain
    version's d > thr and d < −thr (float32 edge cases, ±0 among them), and
    its arc test — the mask built by funnel shifts, doubled by one byte
    permute, then runs of 2, 4, 8, 9 — is the plain version's 9-roll AND on
    every one of the 65,536 circle masks."""
    thr = np.float32(20.0)
    d = np.array([thr, -thr, 0.0, -0.0, 255.0, -255.0, np.nextafter(thr, np.float32(99)),
                  np.nextafter(thr, np.float32(0)), np.nextafter(-thr, np.float32(-99)),
                  np.nextafter(-thr, np.float32(0))], np.float32)
    sign = lambda x: (x.view(np.uint32) >> 31).astype(bool)
    ext = sign(thr - np.abs(d))
    np.testing.assert_array_equal(ext & ~sign(d), d > thr)
    np.testing.assert_array_equal(ext & sign(d), d < -thr)

    m = np.arange(1 << 16, dtype=np.uint32)          # bit k: circle point k passes
    bits = (m[:, None] >> np.arange(16, dtype=np.uint32)) & 1
    mask = np.zeros_like(m)
    for k in range(16):                               # __funnelshift_l(bit, mask, 1)
        mask = (mask << 1) | bits[:, k]
    dd = mask | (mask << 16)                          # __byte_perm(mask, 0, 0x1010)
    r = dd & (dd >> 1)
    r &= r >> 2
    r &= r >> 4
    r &= dd >> 8
    kernel = (r & 0xFFFF) != 0
    acc = bits.astype(bool)
    for k in range(1, 9):                             # fast_score_nms_blur_plain's arc9
        acc = acc & np.roll(bits.astype(bool), -k, axis=1)
    plain = acc.any(axis=1)
    np.testing.assert_array_equal(kernel, plain)
    assert 0 < plain.sum() < plain.size


def test_detect_and_compute_matches(pair):
    img = pair[0]
    uv_j, d_j, v_j, a_j = (np.asarray(x) for x in
                           jorb.detect_and_compute(jnp.asarray(img), num_features=120))
    uv_t, d_t, v_t, a_t = torb.detect_and_compute(torch.as_tensor(img), num_features=120)
    v_t = v_t.numpy()
    assert v_t.sum() == v_j.sum() > 30

    def keyed(uv, v, *cols):
        k = [tuple(p) for p in uv[v].astype(int).tolist()]
        return dict(zip(k, zip(*(c[v] for c in cols))))

    kj = keyed(uv_j, v_j, a_j, d_j)
    kt = keyed(uv_t.numpy(), v_t, a_t.numpy(), _u32(d_t))
    assert set(kj) == set(kt)
    for p, (aj, dj) in kj.items():
        at, dt = kt[p]
        assert abs(float(at) - float(aj)) < 1e-4
        assert sum(bin(int(w)).count("1") for w in np.bitwise_xor(dj, dt)) <= 2


@pytest.mark.parametrize("na,nb", [(130, 300), (17, 5)])
def test_hamming_plain_exact(na, nb):
    rng = np.random.default_rng(na)
    a = rng.integers(0, 2 ** 32, (na, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (nb, 8), dtype=np.uint32)
    got = hamming.hamming_matrix(torch.as_tensor(a.view(np.int32)),
                                 torch.as_tensor(b.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jorb.hamming_matrix(jnp.asarray(a),
                                                                      jnp.asarray(b))))
    np.testing.assert_array_equal(got, np.asarray(
        hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)))
    pm = torb.unpack_pm1(torch.as_tensor(a.view(np.int32))).numpy()
    np.testing.assert_array_equal(pm, np.asarray(jorb.unpack_pm1(jnp.asarray(a))))


def test_mutual_ratio_match_identical(pair):
    """Descriptors of the left image against those of the right."""
    l, r = pair
    _, dl, vl, _ = jorb.detect_and_compute(jnp.asarray(l), num_features=120)
    _, dr, vr, _ = jorb.detect_and_compute(jnp.asarray(r), num_features=120)
    vr = vr.at[:7].set(False)          # exercise the validity masks too
    idx_j, good_j = jorb.mutual_ratio_match(dl, dr, vl, vr, ratio=0.8)
    t = [torch.as_tensor(np.asarray(x).view(np.int32) if x.dtype == jnp.uint32
                         else np.asarray(x)) for x in (dl, dr, vl, vr)]
    idx_t, good_t = torb.mutual_ratio_match(*t, ratio=0.8)
    np.testing.assert_array_equal(good_t.numpy(), np.asarray(good_j))
    g = np.asarray(good_j)
    assert g.sum() > 10
    np.testing.assert_array_equal(idx_t.numpy()[g], np.asarray(idx_j)[g])


def _half(a):
    return a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2).mean(axis=(1, 3))


def _check_maps(disp_t, ok_t, disp_j, ok_j, scale=1.0):
    ok_t, ok_j = np.asarray(ok_t), np.asarray(ok_j)
    both = ok_t & ok_j
    assert both.sum() > 0.2 * ok_j.size
    np.testing.assert_allclose(np.asarray(disp_t)[both], np.asarray(disp_j)[both],
                               atol=1e-3 * scale, rtol=0)
    assert np.mean(ok_t != ok_j) <= 0.01


def test_sweep_plain_matches_interpret_kernel(pair):
    L, R = (_half(a).astype(np.float32) for a in pair)
    d_t, c_t, ok_t = sweep.sweep_maps(torch.as_tensor(L), torch.as_tensor(R))
    d_j, c_j, ok_j = sweep_maps_pallas(jnp.asarray(L), jnp.asarray(R), interpret=True)
    _check_maps(d_t.numpy(), ok_t.numpy(), d_j, ok_j)
    both = ok_t.numpy() & np.asarray(ok_j)
    np.testing.assert_allclose(c_t.numpy()[both], np.asarray(c_j)[both], rtol=1e-5)
    assert not ok_t.numpy()[:, :4].any() and not ok_t.numpy()[:, -4:].any()


def test_disparity_sweep_matches_kernel_route(pair):
    l, r = pair
    d_t, ok_t = tstereo.disparity_sweep(torch.as_tensor(l), torch.as_tensor(r))
    d_j, ok_j = jstereo.disparity_sweep(jnp.asarray(l), jnp.asarray(r), use_kernel=True)
    _check_maps(d_t.numpy(), ok_t.numpy(), d_j, ok_j, scale=2.0)
    # Plane at 2 m: true full-res disparity fx·b/z = 24 px.
    np.testing.assert_allclose(np.median(d_t.numpy()[ok_t.numpy()]), 24.0, atol=0.5)
    uv = np.asarray([[40.0, 30.0], [81.5, 50.25], [120.0, 70.0]], np.float32)
    kd_t, kok_t = tstereo.keypoint_disparity(d_t, ok_t, torch.as_tensor(uv))
    kd_j, kok_j = jstereo.keypoint_disparity(d_j, ok_j, jnp.asarray(uv))
    m = kok_t.numpy() & np.asarray(kok_j)
    np.testing.assert_allclose(kd_t.numpy()[m], np.asarray(kd_j)[m], atol=2e-3)
